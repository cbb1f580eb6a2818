"""Synthetic stereo event-camera simulator for tests and benchmarks
(numpy-only copy of esvo_tpu/io/synthetic.py, kept here so the port
imports nothing of the JAX package).

The reference validates only on recorded rosbags (README.md:86); it ships
no simulator. For a ROS-free, deterministic test/bench story we generate
events from first principles: edges in the scene are 3D points; as the
camera moves, each edge point's projection sweeps across the sensor and
emits an event whenever it has moved ~1 pixel since its last event —
the dominant event-generation mechanism for edge-driven sensors and
exactly the signal ESVO consumes (time surfaces encode edge recency).

Outputs per camera: an EventArray, plus ground-truth poses for evaluation.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from esvo_tpu_torch.io.events import EventArray


@dataclasses.dataclass
class SyntheticScene:
    points: np.ndarray        # (M, 3) world-space edge points
    traj_times: np.ndarray    # (S,)
    traj_poses: np.ndarray    # (S, 4, 4) T_world_cam of the LEFT camera


def make_scene(rng: np.random.Generator, num_points: int = 3000,
               duration: float = 2.0, steps: int = 201,
               motion_scale: float = 1.0,
               structure: str = "segments",
               period: float | None = None) -> SyntheticScene:
    """Edge scene in front of the camera + a smooth trajectory.

    structure="segments": points sampled densely along random 3D line
    segments — event cameras see contiguous *edges*, and both the mapper's
    patch matching and the tracker's edge alignment rely on that contiguity
    (isolated dots give degenerate ZNCC patches and a flat tracking cost).
    structure="points": i.i.d. dots (harder, unrealistic).

    period: motion period in seconds (default: one cycle over the whole
    duration). Pin it when extending `duration` so the angular rate —
    and with it the event rate — stays constant instead of thinning out
    with sequence length.
    """
    if structure == "segments":
        pts_per_seg = 25
        n_seg = max(num_points // pts_per_seg, 1)
        segs = []
        for _ in range(n_seg):
            a = np.array([rng.uniform(-1.0, 1.0), rng.uniform(-0.75, 0.75),
                          rng.uniform(1.2, 3.0)])
            d = rng.normal(size=3)
            d /= np.linalg.norm(d)
            L = rng.uniform(0.15, 0.5)
            ts_ = np.linspace(0.0, 1.0, pts_per_seg)
            segs.append(a[None, :] + (L * ts_)[:, None] * d[None, :])
        pts = np.concatenate(segs, axis=0)
        pts[:, 2] = np.clip(pts[:, 2], 1.2, 3.0)
    else:
        pts = np.stack([rng.uniform(-1.0, 1.0, num_points),
                        rng.uniform(-0.75, 0.75, num_points),
                        rng.uniform(1.2, 3.0, num_points)], axis=1)
    times = np.linspace(0.0, duration, steps)
    poses = np.zeros((steps, 4, 4))
    for i, t in enumerate(times):
        # smooth sinusoidal 6-DoF wiggle
        s = motion_scale
        w = 2 * np.pi / (period or duration)
        tx = 0.10 * s * np.sin(w * t)
        ty = 0.06 * s * np.sin(2 * w * t + 0.4)
        tz = 0.05 * s * (1 - np.cos(w * t))
        rx = 0.04 * s * np.sin(w * t + 0.9)
        ry = 0.05 * s * np.sin(w * t + 0.2)
        rz = 0.03 * s * np.sin(2 * w * t)
        cx, sx = np.cos(rx), np.sin(rx)
        cy, sy = np.cos(ry), np.sin(ry)
        cz, sz = np.cos(rz), np.sin(rz)
        Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        T = np.eye(4)
        T[:3, :3] = Rz @ Ry @ Rx
        T[:3, 3] = [tx, ty, tz]
        poses[i] = T
    return SyntheticScene(points=pts, traj_times=times, traj_poses=poses)


def _project(P: np.ndarray, p_cam: np.ndarray) -> np.ndarray:
    h = p_cam @ P[:, :3].T + P[:, 3]
    return h[:, :2] / h[:, 2:3]


def simulate_stereo_events(scene: SyntheticScene, P_left: np.ndarray,
                           P_right: np.ndarray, width: int, height: int,
                           pixel_threshold: float = 1.0,
                           rng: np.random.Generator | None = None,
                           jitter: float = 0.0):
    """Generate left/right event streams along the trajectory.

    An edge point fires an event in a camera whenever its projection has
    moved >= pixel_threshold since its last event in that camera. Event
    timestamps are linearly interpolated inside each trajectory step.

    Returns (events_left, events_right): EventArray each.
    """
    rng = rng or np.random.default_rng(0)
    streams = {0: [], 1: []}
    last_uv = {}
    for c, Pm in ((0, P_left), (1, P_right)):
        Tw0 = np.linalg.inv(scene.traj_poses[0])
        pc = scene.points @ Tw0[:3, :3].T + Tw0[:3, 3]
        last_uv[c] = _project(Pm, pc)

    for i in range(1, len(scene.traj_times)):
        t0, t1 = scene.traj_times[i - 1], scene.traj_times[i]
        Tinv = np.linalg.inv(scene.traj_poses[i])
        pc = scene.points @ Tinv[:3, :3].T + Tinv[:3, 3]
        front = pc[:, 2] > 0.1
        for c, Pm in ((0, P_left), (1, P_right)):
            uv = _project(Pm, pc)
            d = uv - last_uv[c]
            dist = np.hypot(d[:, 0], d[:, 1])
            nev = np.floor(dist / pixel_threshold).astype(int)
            nev = np.where(front, np.minimum(nev, 8), 0)
            idx = np.nonzero(nev > 0)[0]
            for j in idx:
                for e in range(nev[j]):
                    a = (e + 1) / (nev[j] + 1e-9)
                    u = last_uv[c][j, 0] + a * d[j, 0]
                    v = last_uv[c][j, 1] + a * d[j, 1]
                    if jitter > 0:
                        u += rng.normal(0, jitter)
                        v += rng.normal(0, jitter)
                    if 0 <= u < width and 0 <= v < height:
                        te = t0 + a * (t1 - t0)
                        pol = d[j, 0] + d[j, 1] > 0
                        streams[c].append((te, int(u), int(v), pol))
            moved = nev > 0
            last_uv[c][moved] = uv[moved]

    out = []
    for c in (0, 1):
        if streams[c]:
            arr = sorted(streams[c])
            t = np.array([e[0] for e in arr])
            x = np.array([e[1] for e in arr], np.int32)
            y = np.array([e[2] for e in arr], np.int32)
            p = np.array([e[3] for e in arr], bool)
        else:
            t = np.zeros(0)
            x = y = np.zeros(0, np.int32)
            p = np.zeros(0, bool)
        out.append(EventArray(t=t, x=x, y=y, p=p))
    return out[0], out[1]


def inject_sensor_noise(ev: EventArray, width: int, height: int,
                        rng: np.random.Generator,
                        num_hot_pixels: int = 8,
                        hot_rate_hz: float = 2000.0,
                        flicker_rate_hz: float = 0.0) -> EventArray:
    """Add the sensor artefacts the reference's denoiser targets
    (esvo_Mapping.cpp:1046-1072: flicker from VICON IR + hot pixels):
    a few isolated pixels firing at kHz rates, polarity alternating.
    Returns a new time-sorted EventArray."""
    if len(ev.t) == 0:
        return ev
    t0, t1 = float(ev.t[0]), float(ev.t[-1])
    parts_t = [ev.t]
    parts_x = [ev.x]
    parts_y = [ev.y]
    parts_p = [ev.p]
    hx = rng.integers(2, width - 2, num_hot_pixels)
    hy = rng.integers(2, height - 2, num_hot_pixels)
    for i in range(num_hot_pixels):
        n = max(int((t1 - t0) * hot_rate_hz), 1)
        tt = np.sort(rng.uniform(t0, t1, n))
        parts_t.append(tt)
        parts_x.append(np.full(n, hx[i], np.int32))
        parts_y.append(np.full(n, hy[i], np.int32))
        parts_p.append((np.arange(n) % 2) == 0)
    if flicker_rate_hz > 0:
        # full-frame flicker bursts (fluorescent / IR strobes)
        n_bursts = max(int((t1 - t0) * flicker_rate_hz), 1)
        for tb in rng.uniform(t0, t1, n_bursts):
            m = rng.integers(50, 150)
            parts_t.append(np.full(m, tb))
            parts_x.append(rng.integers(0, width, m).astype(np.int32))
            parts_y.append(rng.integers(0, height, m).astype(np.int32))
            parts_p.append(rng.random(m) > 0.5)
    t = np.concatenate(parts_t)
    order = np.argsort(t, kind="stable")
    return EventArray(t=t[order],
                      x=np.concatenate(parts_x)[order],
                      y=np.concatenate(parts_y)[order],
                      p=np.concatenate(parts_p)[order],
                      t_offset=ev.t_offset)


def interpolate_pose(times: np.ndarray, poses: np.ndarray,
                     t: float) -> np.ndarray:
    """Pose at time t from a stamped table: translation lerp + rotation
    lerp projected back to SO(3) (SVD). Queries outside the table clamp
    to the end segments (same rule as esvo_tpu/eval/trajectory.py)."""
    i = int(np.clip(np.searchsorted(times, t), 1, len(times) - 1))
    t0, t1 = times[i - 1], times[i]
    a = 0.0 if t1 == t0 else float(np.clip((t - t0) / (t1 - t0), 0.0, 1.0))
    T0, T1 = poses[i - 1], poses[i]
    M = (1 - a) * T0[:3, :3] + a * T1[:3, :3]
    U, _, Vt = np.linalg.svd(M)
    R = U @ np.diag([1, 1, np.sign(np.linalg.det(U @ Vt))]) @ Vt
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = (1 - a) * T0[:3, 3] + a * T1[:3, 3]
    return T


def interpolate_gt_pose(scene: SyntheticScene, t: float) -> np.ndarray:
    """GT pose lookup on the scene's stamped trajectory."""
    return interpolate_pose(np.asarray(scene.traj_times),
                            np.asarray(scene.traj_poses), t)
