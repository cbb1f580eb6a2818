"""Sensor-realistic contrast-threshold event-camera simulator (port of
esvo_tpu/io/esim.py).

The standard event-camera model (ESIM-style) over an analytic scene of
textured planes:

- the scene rendered to per-pixel log intensity (and exact depth);
- per-pixel reference levels: an event fires each time log intensity
  crosses a contrast threshold C since the pixel's last event, its
  timestamp linearly interpolated inside the render substep;
- per-pixel threshold fixed-pattern noise, a refractory period;
- background / leak noise and hot pixels firing at kHz rates.

Same functions, arguments and results as the JAX module. The simulation
runs on the device a substep at a time (the JAX package scans a jitted
chunk); each substep's candidates are compacted in flat (slot, y, x)
order with ``torch.nonzero``, which waits for the device once a substep,
and kept up to the budget with the overflow counted, exactly as JAX's
``jnp.nonzero(size=B)``. The noise draws come from a ``torch.Generator``
on the device seeded from the same numpy draw as JAX's PRNG key, so with
the noise off (``background_rate_hz=0``, ``num_hot_pixels=0``) the two
packages emit the same events up to float32 rounding of the renderer.
"""
from __future__ import annotations

import dataclasses
import json
import os
import warnings

import numpy as np
import torch

from esvo_tpu_torch._device import constant, resolve_device
from esvo_tpu_torch.io.events import EventArray
from esvo_tpu_torch.utils.precision import highest_precision


# ---------------------------------------------------------------------------
# scene: textured planes
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PlaneScene:
    """Bounded textured planes. Arrays over the plane axis:

    p0 (P, 3) corner, e1/e2 (P, 3) edge vectors (their length is the
    plane extent), n (P, 3) unit normal. Texture: per-plane band-limited
    log intensity  L(s) = sum_k a_k sin(2 pi f_k . s + phi_k)  plus soft
    step edges  b tanh(s * sin(2 pi g . s + psi)).  s = (u, v) in
    plane-local [0, 1]^2.
    """
    p0: np.ndarray       # (P, 3)
    e1: np.ndarray       # (P, 3)
    e2: np.ndarray       # (P, 3)
    n: np.ndarray        # (P, 3) unit
    tex_amp: np.ndarray  # (P, K)
    tex_freq: np.ndarray  # (P, K, 2) cycles per plane
    tex_phase: np.ndarray  # (P, K)
    edge_amp: np.ndarray   # (P, E)
    edge_freq: np.ndarray  # (P, E, 2)
    edge_phase: np.ndarray  # (P, E)
    edge_sharp: float = 8.0

    def save(self, path: str) -> None:
        np.savez(path, **{f.name: getattr(self, f.name)
                          for f in dataclasses.fields(self)})

    @staticmethod
    def load(path: str) -> "PlaneScene":
        d = np.load(path)
        kw = {k: d[k] for k in d.files}
        kw["edge_sharp"] = float(kw["edge_sharp"])
        return PlaneScene(**kw)


def make_room_scene(rng: np.random.Generator,
                    half_width: float = 2.0,
                    half_height: float = 1.5,
                    depth: float = 4.0,
                    octaves: int = 6,
                    edges: int = 5) -> PlaneScene:
    """A box room seen from the origin looking down +z: back wall at
    z=depth, side walls, floor and ceiling. Every camera ray hits a plane,
    so rendering is total (no sky)."""
    W, Hh, D = half_width, half_height, depth
    # p0 + s1*e1 + s2*e2, s in [0,1]^2
    planes = [
        # back wall
        (np.array([-W, -Hh, D]), np.array([2 * W, 0, 0]),
         np.array([0, 2 * Hh, 0])),
        # left wall (x = -W)
        (np.array([-W, -Hh, -1.0]), np.array([0, 0, D + 1.0]),
         np.array([0, 2 * Hh, 0])),
        # right wall (x = +W)
        (np.array([W, -Hh, -1.0]), np.array([0, 0, D + 1.0]),
         np.array([0, 2 * Hh, 0])),
        # floor (y = +Hh: image y grows downward)
        (np.array([-W, Hh, -1.0]), np.array([2 * W, 0, 0]),
         np.array([0, 0, D + 1.0])),
        # ceiling (y = -Hh)
        (np.array([-W, -Hh, -1.0]), np.array([2 * W, 0, 0]),
         np.array([0, 0, D + 1.0])),
        # front wall behind the camera (closes the box)
        (np.array([-W, -Hh, -1.0]), np.array([2 * W, 0, 0]),
         np.array([0, 2 * Hh, 0])),
    ]
    P = len(planes)
    p0 = np.stack([p[0] for p in planes]).astype(np.float64)
    e1 = np.stack([p[1] for p in planes]).astype(np.float64)
    e2 = np.stack([p[2] for p in planes]).astype(np.float64)
    n = np.cross(e1, e2)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    K, E = octaves, edges
    amp = rng.uniform(0.05, 0.18, (P, K)) / np.sqrt(np.arange(1, K + 1))
    freq = rng.uniform(1.0, 3.0, (P, K, 2)) * \
        (2.0 ** np.arange(K))[None, :, None] * 0.5
    phase = rng.uniform(0, 2 * np.pi, (P, K))
    e_amp = rng.uniform(0.10, 0.25, (P, E))
    e_freq = rng.uniform(0.8, 5.0, (P, E, 2))
    e_phase = rng.uniform(0, 2 * np.pi, (P, E))
    return PlaneScene(p0=p0, e1=e1, e2=e2, n=n, tex_amp=amp, tex_freq=freq,
                      tex_phase=phase, edge_amp=e_amp, edge_freq=e_freq,
                      edge_phase=e_phase)


def _scene_tensors(scene: PlaneScene, device) -> dict:
    """The scene's arrays as float32 tensors on `device`, built once per
    simulation."""
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                  device=device)
    return dict(n=f(scene.n), p0=f(scene.p0), e1=f(scene.e1), e2=f(scene.e2),
                amp=f(scene.tex_amp), f1=f(scene.tex_freq[:, :, 0]),
                f2=f(scene.tex_freq[:, :, 1]), ph=f(scene.tex_phase),
                ea=f(scene.edge_amp), g1=f(scene.edge_freq[:, :, 0]),
                g2=f(scene.edge_freq[:, :, 1]), ps=f(scene.edge_phase),
                sharp=float(scene.edge_sharp))


def _render(st: dict, T_world_cam: torch.Tensor, K: torch.Tensor,
            width: int, height: int):
    """render_log_intensity on prepared scene tensors."""
    dtype, dev = torch.float32, T_world_cam.device
    u = torch.arange(width, dtype=dtype, device=dev)[None, :]
    v = torch.arange(height, dtype=dtype, device=dev)[:, None]
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    # camera-frame ray with dz = 1 so the ray parameter IS camera depth
    dx = (u - cx) / fx + 0.0 * v
    dy = (v - cy) / fy + 0.0 * u
    R = T_world_cam[:3, :3].to(dtype)
    o = T_world_cam[:3, 3].to(dtype)
    rx = R[0, 0] * dx + R[0, 1] * dy + R[0, 2]
    ry = R[1, 0] * dx + R[1, 1] * dy + R[1, 2]
    rz = R[2, 0] * dx + R[2, 1] * dy + R[2, 2]

    # all planes at once: (P, H, W) intermediates
    nrm, p0, e1, e2 = st["n"], st["p0"], st["e1"], st["e2"]
    bx = lambda a: a[:, None, None]
    denom = bx(nrm[:, 0]) * rx + bx(nrm[:, 1]) * ry + bx(nrm[:, 2]) * rz
    num = torch.sum(nrm * p0, dim=1) - torch.matmul(nrm, o)   # (P,)
    t = bx(num) / torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
    hx = o[0] + t * rx - bx(p0[:, 0])
    hy = o[1] + t * ry - bx(p0[:, 1])
    hz = o[2] + t * rz - bx(p0[:, 2])
    l1 = torch.sum(e1 * e1, dim=1)
    l2 = torch.sum(e2 * e2, dim=1)
    s1 = (bx(e1[:, 0]) * hx + bx(e1[:, 1]) * hy + bx(e1[:, 2]) * hz) \
        / bx(l1)
    s2 = (bx(e2[:, 0]) * hx + bx(e2[:, 1]) * hy + bx(e2[:, 2]) * hz) \
        / bx(l2)
    hit = (t > 1e-4) & (s1 >= -1e-4) & (s1 <= 1 + 1e-4) \
        & (s2 >= -1e-4) & (s2 <= 1 + 1e-4)
    # texture: (P, K, H, W) reduced over K
    b2 = lambda a: a[:, :, None, None]
    L = torch.sum(b2(st["amp"]) * torch.sin(
        2 * np.pi * (b2(st["f1"]) * s1[:, None] + b2(st["f2"]) * s2[:, None])
        + b2(st["ph"])), dim=1)
    L = L + torch.sum(b2(st["ea"]) * torch.tanh(st["sharp"] * torch.sin(
        2 * np.pi * (b2(st["g1"]) * s1[:, None] + b2(st["g2"]) * s2[:, None])
        + b2(st["ps"]))), dim=1)
    t_masked = torch.where(hit, t, torch.inf)
    best = torch.argmin(t_masked, dim=0)                 # (H, W)
    logI = torch.take_along_dim(L, best[None], dim=0)[0]
    best_t = torch.take_along_dim(t_masked, best[None], dim=0)[0]
    logI = torch.where(torch.isfinite(best_t), logI, 0.0)
    return logI, best_t


@highest_precision()
def render_log_intensity(scene: PlaneScene, T_world_cam: torch.Tensor,
                         K: torch.Tensor, width: int, height: int):
    """Render (log_intensity, depth) (H, W) float32 for a pinhole camera
    at T_world_cam (4, 4), on T_world_cam's device. Depth is the
    camera-frame z of the nearest plane hit."""
    K = torch.as_tensor(K, dtype=torch.float32, device=T_world_cam.device)
    return _render(_scene_tensors(scene, T_world_cam.device), T_world_cam,
                   K, width, height)


# ---------------------------------------------------------------------------
# trajectory: smooth closed loop
# ---------------------------------------------------------------------------

def loop_trajectory_pose(t, duration: float,
                         amp_t=(0.8, 0.35, 0.9),
                         amp_r=(0.10, 0.22, 0.06),
                         laps: int = 1) -> np.ndarray:
    """Analytic C-inf closed 6-DoF trajectory: the camera returns exactly
    to its start pose at t = duration (and at each lap boundary), giving
    the loop-closure backend genuine revisits. Units: meters / radians."""
    w = 2 * np.pi * laps / duration
    tx = amp_t[0] * np.sin(w * t)
    ty = amp_t[1] * np.sin(2 * w * t + 0.4) \
        - amp_t[1] * np.sin(0.4)
    tz = amp_t[2] * 0.5 * (1 - np.cos(w * t))
    rx = amp_r[0] * np.sin(w * t + 0.9) - amp_r[0] * np.sin(0.9)
    ry = amp_r[1] * np.sin(w * t)
    rz = amp_r[2] * np.sin(2 * w * t)
    cx_, sx_ = np.cos(rx), np.sin(rx)
    cy_, sy_ = np.cos(ry), np.sin(ry)
    cz_, sz_ = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx_, -sx_], [0, sx_, cx_]])
    Ry = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]])
    Rz = np.array([[cz_, -sz_, 0], [sz_, cz_, 0], [0, 0, 1]])
    T = np.eye(4)
    T[:3, :3] = Rz @ Ry @ Rx
    T[:3, 3] = [tx, ty, tz]
    return T


# ---------------------------------------------------------------------------
# sensor model
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SensorConfig:
    contrast_threshold: float = 0.18
    threshold_fpn_sigma: float = 0.03   # per-pixel fixed-pattern noise on C
    refractory_us: float = 100.0
    max_events_per_px_step: int = 3     # per substep (counted overflow)
    background_rate_hz: float = 0.3     # leak noise per pixel
    num_hot_pixels: int = 8
    hot_pixel_rate_hz: float = 1000.0   # capped at the substep rate
    substep_dt: float = 1e-3
    # per-substep compaction budget; <= 0 means auto (= H*W). Overflow is
    # counted AND warned about: the flat-index compaction drops later
    # per-pixel crossings and the noise slot first, a biased loss that
    # must never silently truncate a campaign's stream.
    event_budget_per_step: int = 0


def _camera_step(st: dict, K: torch.Tensor, width: int, height: int,
                 cfg: SensorConfig, carry, pose12: torch.Tensor,
                 t0: torch.Tensor, c_pos, c_neg, leak_p,
                 gen: torch.Generator):
    """One substep of one camera (the body of JAX's per-chunk scan).

    carry: (ref logI, last event time); pose12: (12,) row-major [R|t] at
    the substep's end; t0: the substep's start time (0-d float32).
    Returns (carry, (t (m,), flat code (m,), polarity (m,), count)) with
    the first m = min(count, budget) candidates in flat (slot, y, x)
    order."""
    E = cfg.max_events_per_px_step
    B = cfg.event_budget_per_step
    t_ref = cfg.refractory_us * 1e-6
    dev = pose12.device
    ref, last_t = carry
    T = torch.cat([pose12.reshape(3, 4),
                   constant(((0., 0., 0., 1.),), torch.float32, dev)], dim=0)
    L, _ = _render(st, T, K, width, height)
    t1 = t0 + cfg.substep_dt
    delta = L - ref
    pol = delta >= 0
    c_px = torch.where(pol, c_pos, c_neg)
    n = torch.floor(torch.abs(delta) / c_px).to(torch.int32)
    n_emit = torch.clamp(n, max=E)
    # candidate slots i = 0..E-1: timestamps linearly interpolated inside
    # the substep; refractory drops (but still absorbs)
    ts, oks = [], []
    lt = last_t
    n1 = n_emit.to(torch.float32) + 1.0
    for i in range(E):
        te = t0 + (i + 1.0) / n1 * cfg.substep_dt
        ok = (i < n_emit) & (te - lt >= t_ref)
        lt = torch.where(ok, te, lt)
        ts.append(te)
        oks.append(ok)
    # the reference absorbs the emitted-or-refractory-dropped crossings
    ref = ref + torch.sign(delta) * n_emit.to(torch.float32) * c_px
    # leak / hot-pixel noise: one Bernoulli candidate per substep, random
    # polarity, does not move ref
    hw = (height, width)
    fire = torch.rand(hw, generator=gen, device=dev) < leak_p
    fire = fire & (t1 - lt >= t_ref)
    npol = torch.rand(hw, generator=gen, device=dev) < 0.5
    tn = t0 + 0.5 * cfg.substep_dt
    lt = torch.where(fire, tn, lt)

    cand_t = torch.stack(ts + [tn.expand(hw)], 0)
    cand_ok = torch.stack(oks + [fire], 0).reshape(-1)
    cand_p = torch.stack([pol] * E + [npol], 0)
    count = torch.sum(cand_ok.to(torch.int32))
    # flat (slot, y, x) order, the first B kept (waits for the device)
    idx = torch.nonzero(cand_ok).reshape(-1)[:B]
    out = (cand_t.reshape(-1)[idx], idx.to(torch.int32),
           cand_p.reshape(-1)[idx], count)
    return (ref, lt), out


def _sensor_maps(cfg: SensorConfig, width: int, height: int,
                 rng: np.random.Generator):
    """The per-pixel sensor maps and the noise seed, drawn from `rng` in
    the JAX package's order (c_pos, c_neg, the hot pixels' x then y, the
    PRNG seed), so they equal JAX's bit for bit: (c_pos, c_neg, leak
    probability per substep) as float32 (H, W) arrays, and the seed."""
    c = cfg.contrast_threshold
    c_pos = c * (1 + cfg.threshold_fpn_sigma * rng.standard_normal(
        (height, width)))
    c_neg = c * (1 + cfg.threshold_fpn_sigma * rng.standard_normal(
        (height, width)))
    c_pos = np.clip(c_pos, 0.3 * c, 3 * c).astype(np.float32)
    c_neg = np.clip(c_neg, 0.3 * c, 3 * c).astype(np.float32)
    leak = np.full((height, width),
                   cfg.background_rate_hz * cfg.substep_dt)
    if cfg.num_hot_pixels > 0:
        hx = rng.integers(2, width - 2, cfg.num_hot_pixels)
        hy = rng.integers(2, height - 2, cfg.num_hot_pixels)
        leak[hy, hx] = min(cfg.hot_pixel_rate_hz * cfg.substep_dt, 1.0)
    seed = int(rng.integers(0, 2 ** 31))
    return c_pos, c_neg, leak.astype(np.float32), seed


@highest_precision()
def simulate_camera(scene: PlaneScene, K: np.ndarray, width: int,
                    height: int, pose_fn, t_start: float, t_end: float,
                    cfg: SensorConfig, rng: np.random.Generator,
                    chunk_steps: int = 256, progress=None, device=None):
    """Simulate one camera over [t_start, t_end). pose_fn(t) -> (4, 4)
    T_world_cam. Runs on `device` (``cuda`` unless given). Returns
    (EventArray, stats dict)."""
    dev = resolve_device(device)
    if cfg.event_budget_per_step <= 0:
        cfg = dataclasses.replace(cfg,
                                  event_budget_per_step=max(4096,
                                                            width * height))
    B, HW = cfg.event_budget_per_step, height * width
    # the per-chunk grouping of JAX's scan (progress reports per chunk)
    chunk_steps = max(8, min(chunk_steps, int(64e6 / (B * 9))))
    n_steps = int(round((t_end - t_start) / cfg.substep_dt))
    c_pos, c_neg, leak, seed = _sensor_maps(cfg, width, height, rng)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    c_pos, c_neg, leak = f32(c_pos), f32(c_neg), f32(leak)

    st = _scene_tensors(scene, dev)
    Kt = f32(K)
    # initial reference = first frame (no event burst at t=0)
    ref, _ = _render(st, f32(pose_fn(t_start)), Kt, width, height)
    last_t = torch.full((height, width), t_start - 1.0, dtype=torch.float32,
                        device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    carry = (ref, last_t)

    parts = []
    overflow = 0
    total = 0
    for s0 in range(0, n_steps, chunk_steps):
        s1 = min(s0 + chunk_steps, n_steps)
        tt = t_start + (s0 + np.arange(s1 - s0)) * cfg.substep_dt
        poses = f32(np.stack([np.asarray(pose_fn(float(t + cfg.substep_dt)),
                                         np.float32)[:3, :].reshape(12)
                              for t in tt]))
        t_dev = f32(tt)
        outs = []
        for k in range(s1 - s0):
            carry, o = _camera_step(st, Kt, width, height, cfg, carry,
                                    poses[k], t_dev[k], c_pos, c_neg, leak,
                                    gen)
            outs.append(o)
        ot = torch.cat([o[0] for o in outs]).cpu().numpy()
        oidx = torch.cat([o[1] for o in outs]).cpu().numpy()
        op = torch.cat([o[2] for o in outs]).cpu().numpy()
        ocnt = torch.stack([o[3] for o in outs]).cpu().numpy()
        overflow += int(np.maximum(ocnt.astype(np.int64) - B, 0).sum())
        total += len(ot)
        parts.append((ot, oidx, op))
        if progress is not None:
            progress(s1, n_steps, total)

    t = np.concatenate([p[0] for p in parts]) if parts else \
        np.zeros(0, np.float32)
    idx = np.concatenate([p[1] for p in parts]) if parts else \
        np.zeros(0, np.int32)
    p = np.concatenate([p[2] for p in parts]) if parts else \
        np.zeros(0, bool)
    pix = idx % HW
    x = (pix % width).astype(np.int32)
    y = (pix // width).astype(np.int32)
    order = np.argsort(t, kind="stable")
    ev = EventArray(t=t[order].astype(np.float64), x=x[order], y=y[order],
                    p=p[order])
    stats = {"events": int(len(ev)), "overflow_dropped": int(overflow),
             "rate_ev_per_s": float(len(ev) / max(t_end - t_start, 1e-9))}
    produced = total + overflow
    if produced and overflow / produced > 0.01:
        warnings.warn(
            f"esim: budget dropped {overflow}/{produced} events "
            f"({100 * overflow / produced:.1f}%) — a biased loss (later "
            f"per-pixel crossings and leak/hot noise go first); raise "
            f"SensorConfig.event_budget_per_step (0 = auto H*W)")
    return ev, stats


def simulate_stereo(scene: PlaneScene, K: np.ndarray, width: int,
                    height: int, baseline: float, pose_fn, t_start: float,
                    t_end: float, cfg: SensorConfig,
                    rng: np.random.Generator, chunk_steps: int = 256,
                    progress=None, device=None):
    """Simulate both cameras of a rectified rig: the right camera sits at
    +baseline along x in the left frame (T_right_left translation
    -baseline, matching geometry.camera.make_ideal_rig). Returns
    (ev_left, ev_right, stats)."""
    T_lr = np.eye(4)
    T_lr[0, 3] = baseline  # T_world_right = T_world_left @ T_left_right

    def pose_right(t):
        return pose_fn(t) @ T_lr

    ev_l, st_l = simulate_camera(scene, K, width, height, pose_fn,
                                 t_start, t_end, cfg, rng, chunk_steps,
                                 progress, device)
    ev_r, st_r = simulate_camera(scene, K, width, height, pose_right,
                                 t_start, t_end, cfg, rng, chunk_steps,
                                 progress, device)
    return ev_l, ev_r, {"left": st_l, "right": st_r}


# ---------------------------------------------------------------------------
# dataset export (rpg directory layout read by scripts/torch_run_dataset.py)
# ---------------------------------------------------------------------------

def write_calib_yaml(path: str, K: np.ndarray, width: int, height: int,
                     baseline: float, right: bool) -> None:
    """ESVO-format calibration yaml (CameraSystem::loadCalibInfo schema):
    ideal rectified pinhole, zero distortion. Values are builtin
    float/int (yaml.safe_dump refuses numpy scalars)."""
    fx, fy = float(K[0, 0]), float(K[1, 1])
    cx, cy = float(K[0, 2]), float(K[1, 2])
    baseline = float(baseline)
    tx = -fx * baseline if right else 0.0
    P = [fx, 0.0, cx, tx, 0.0, fy, cy, 0.0, 0.0, 0.0, 1.0, 0.0]
    T_rl = [1.0, 0.0, 0.0, -baseline,
            0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0]
    data = {
        "image_width": int(width), "image_height": int(height),
        "camera_matrix": {"rows": 3, "cols": 3,
                          "data": [fx, 0.0, cx, 0.0, fy, cy,
                                   0.0, 0.0, 1.0]},
        "distortion_model": "plumb_bob",
        "distortion_coefficients": {"rows": 1, "cols": 4,
                                    "data": [0.0, 0.0, 0.0, 0.0]},
        "rectification_matrix": {"rows": 3, "cols": 3,
                                 "data": [1.0, 0.0, 0.0, 0.0, 1.0, 0.0,
                                          0.0, 0.0, 1.0]},
        "projection_matrix": {"rows": 3, "cols": 4, "data": P},
        "T_right_left": {"rows": 3, "cols": 4, "data": T_rl},
    }
    import yaml
    with open(path, "w") as f:
        yaml.safe_dump(data, f, sort_keys=False)


def export_dataset(out_dir: str, scene: PlaneScene, K: np.ndarray,
                   width: int, height: int, baseline: float,
                   ev_l: EventArray, ev_r: EventArray,
                   gt_times: np.ndarray, gt_poses: np.ndarray,
                   meta: dict | None = None) -> None:
    """Write an rpg-layout dataset directory (events as packed npz,
    groundtruth.txt in TUM format, calib/{left,right}.yaml, scene.npz +
    meta.json for analytic depth evaluation)."""
    from esvo_tpu_torch.io.events import save_events_npz
    from esvo_tpu_torch.eval.trajectory import save_tum
    os.makedirs(out_dir, exist_ok=True)
    os.makedirs(os.path.join(out_dir, "calib"), exist_ok=True)
    save_events_npz(os.path.join(out_dir, "events_left.npz"), ev_l)
    save_events_npz(os.path.join(out_dir, "events_right.npz"), ev_r)
    save_tum(os.path.join(out_dir, "groundtruth.txt"), gt_times, gt_poses)
    write_calib_yaml(os.path.join(out_dir, "calib", "left.yaml"),
                     K, width, height, baseline, right=False)
    write_calib_yaml(os.path.join(out_dir, "calib", "right.yaml"),
                     K, width, height, baseline, right=True)
    scene.save(os.path.join(out_dir, "scene.npz"))
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump({"width": width, "height": height,
                   "baseline": baseline,
                   "K": np.asarray(K, float).tolist(),
                   **(meta or {})}, f, indent=1)
