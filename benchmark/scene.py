"""The benchmark's traffic: a seeded synthetic stereo event stream on a
distorted, rectified rig, replayed in laps of one motion period.

Frozen and vectorized from chip_smoke.py (``RIGS`` / ``make_rig``,
``SCENES`` / ``make_events``, ``_to_raw``) and the numpy parts of
esvo_tpu_torch/io/synthetic.py (``make_scene``'s edge segments and
trajectory, ``simulate_stereo_events``) and io/events.py
(``frame_events``), so a later change to the port cannot move the
traffic. The rectification maps that turn rectified events into raw
sensor pixels come from the plain reference's camera model in float64.

The trajectory uses sines of w and 2w only, so it repeats exactly every
period: one period is simulated (after a warm-up that settles each edge
point's last event position), and lap L replays it shifted by L
periods. The ground truth at t is the closed form at t mod period. The
scene is the configuration's, from its own seed, so every run does the
same work; a run's seed picks where in the period it starts.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def _rot(ay: float, ax: float) -> np.ndarray:
    cy, sy, cx, sx = math.cos(ay), math.sin(ay), math.cos(ax), math.sin(ax)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    return Ry @ Rx


def rig_params(rig: dict) -> dict:
    """The rig a configuration states, as plain arrays: raw intrinsics K
    and plumb_bob distortion D shared by both cameras, each camera's
    rectification rotation R and rectified projection P, the baseline
    and T_right_left. Both the program and the reference build their
    rectification maps from these."""
    W, H = rig["width"], rig["height"]
    fx, fy, cx, cy = rig["K"]
    f, b = rig["f_rect"], rig["baseline"]
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
    cams = []
    for (ay, ax), tx in zip(rig["rect_angles"], (0.0, -f * b)):
        P = np.array([[f, 0, W / 2, tx], [0, f, H / 2, 0], [0, 0, 1, 0]],
                     np.float64)
        cams.append(dict(K=K, D=np.array(rig["D"], np.float64),
                         R=_rot(ay, ax), P=P))
    T = np.eye(4)
    T[0, 3] = -b
    return dict(width=W, height=H, model=rig["model"], left=cams[0],
                right=cams[1], T_right_left=T, baseline=float(b))


def build_rig(params: dict, mod, dtype, device):
    """A StereoRig of the camera module `mod` (the program's
    ``esvo_tpu_torch.geometry.camera`` or the reference's copy) from
    rig_params: each side computes its own maps."""
    kw = dict(dtype=dtype, device=device)
    t = lambda a: torch.as_tensor(np.asarray(a), **kw)
    cams = [mod.make_camera(mod.PinholeParams(
        K=t(c["K"]), D=t(c["D"]), R=t(c["R"]), P=t(c["P"]),
        width=params["width"], height=params["height"],
        model=params["model"])) for c in (params["left"], params["right"])]
    return mod.StereoRig(left=cams[0], right=cams[1],
                         T_right_left=t(params["T_right_left"]),
                         baseline=t(params["baseline"]))


def pose_at(t, period: float, scale: float, motion_scale: float = 1.0):
    """T_world_cam of the left camera at time(s) t (make_scene's 6-DoF
    wiggle, its translation scaled by `scale`): (4, 4) or (n, 4, 4)."""
    t = np.atleast_1d(np.asarray(t, np.float64))
    s, w = motion_scale, 2 * np.pi / period
    tx = 0.10 * s * np.sin(w * t)
    ty = 0.06 * s * np.sin(2 * w * t + 0.4)
    tz = 0.05 * s * (1 - np.cos(w * t))
    rx = 0.04 * s * np.sin(w * t + 0.9)
    ry = 0.05 * s * np.sin(w * t + 0.2)
    rz = 0.03 * s * np.sin(2 * w * t)
    cx, sx, cy, sy, cz, sz = (np.cos(rx), np.sin(rx), np.cos(ry),
                              np.sin(ry), np.cos(rz), np.sin(rz))
    o, z = np.ones_like(t), np.zeros_like(t)
    Rx = np.stack([o, z, z, z, cx, -sx, z, sx, cx], -1).reshape(-1, 3, 3)
    Ry = np.stack([cy, z, sy, z, o, z, -sy, z, cy], -1).reshape(-1, 3, 3)
    Rz = np.stack([cz, -sz, z, sz, cz, z, z, z, o], -1).reshape(-1, 3, 3)
    T = np.tile(np.eye(4), (len(t), 1, 1))
    T[:, :3, :3] = Rz @ Ry @ Rx
    T[:, :3, 3] = scale * np.stack([tx, ty, tz], -1)
    return T if len(t) > 1 else T[0]


def edge_points(rng: np.random.Generator, num_points: int,
                scale: float) -> np.ndarray:
    """make_scene's "segments" structure, drawn in its order: points
    along random 3D segments of 25 points at 1.2-3 m, scaled by
    `scale`."""
    per = 25
    s = np.linspace(0.0, 1.0, per)
    segs = []
    for _ in range(max(num_points // per, 1)):
        a = np.array([rng.uniform(-1.0, 1.0), rng.uniform(-0.75, 0.75),
                      rng.uniform(1.2, 3.0)])
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        L = rng.uniform(0.15, 0.5)
        segs.append(a[None, :] + (L * s)[:, None] * d[None, :])
    pts = np.concatenate(segs, axis=0)
    pts[:, 2] = np.clip(pts[:, 2], 1.2, 3.0)
    return pts * scale


def _project(P: np.ndarray, p: np.ndarray) -> np.ndarray:
    h = p @ P[:, :3].T + P[:, 3]
    return h[..., :2] / h[..., 2:3]


def simulate(points, times, poses, P_cams, width: int, height: int,
             threshold: float):
    """simulate_stereo_events, vectorized: an edge point fires in a
    camera each time its projection has moved `threshold` px since its
    last event there (at most 8 a step), at positions and times
    interpolated inside the step. Returns per camera (t, x, y, p) sorted
    as the original sorts its tuples."""
    out = []
    for P in P_cams:
        Tw = np.linalg.inv(poses[0])
        last = _project(P, points @ Tw[:3, :3].T + Tw[:3, 3])
        parts = []
        for i in range(1, len(times)):
            t0, t1 = times[i - 1], times[i]
            Tw = np.linalg.inv(poses[i])
            pc = points @ Tw[:3, :3].T + Tw[:3, 3]
            uv = _project(P, pc)
            d = uv - last
            nev = np.floor(np.hypot(d[:, 0], d[:, 1]) / threshold).astype(
                np.int64)
            nev = np.where(pc[:, 2] > 0.1, np.minimum(nev, 8), 0)
            idx = np.nonzero(nev > 0)[0]
            if idx.size:
                reps = nev[idx]
                j = np.repeat(idx, reps)
                first = np.repeat(np.cumsum(reps) - reps, reps)
                e = np.arange(j.size) - first
                a = (e + 1) / (nev[j] + 1e-9)
                u = last[j, 0] + a * d[j, 0]
                v = last[j, 1] + a * d[j, 1]
                keep = (u >= 0) & (u < width) & (v >= 0) & (v < height)
                ev = np.stack([
                    (t0 + a * (t1 - t0))[keep], np.floor(u[keep]),
                    np.floor(v[keep]),
                    (d[j, 0] + d[j, 1] > 0)[keep].astype(np.float64)], 1)
                # a step's events lie inside (t0, t1): sorting each step
                # sorts the stream
                parts.append(ev[np.lexsort((ev[:, 3], ev[:, 2], ev[:, 1],
                                            ev[:, 0]))])
            moved = nev > 0
            last[moved] = uv[moved]
        ev = np.concatenate(parts) if parts else np.zeros((0, 4))
        out.append((ev[:, 0], ev[:, 1].astype(np.int32),
                    ev[:, 2].astype(np.int32), ev[:, 3] > 0.5))
    return out


def to_raw(ev, inv_map: np.ndarray, mask: np.ndarray):
    """chip_smoke._to_raw: events at rectified pixels -> the raw sensor
    pixels the rectification map samples there (pixels off the sensor
    dropped)."""
    t, x, y, p = ev
    H, W = mask.shape
    raw = inv_map[y, x]
    xr = np.floor(raw[:, 0]).astype(np.int32)
    yr = np.floor(raw[:, 1]).astype(np.int32)
    keep = mask[y, x] & (xr >= 0) & (xr < W) & (yr >= 0) & (yr < H)
    return t[keep], xr[keep], yr[keep], p[keep]


def frame(ev, edges: np.ndarray, capacity: int) -> dict:
    """frame_events: tick k takes the events in (edges[k], edges[k+1]],
    the first `capacity` of them. Returns (K, capacity) arrays x, y (int32),
    t (float64, for the laps' shift), p, valid and (K,) dropped."""
    t, x, y, p = ev
    K = len(edges) - 1
    lo = np.searchsorted(t, edges[:-1], side="right")
    hi = np.searchsorted(t, edges[1:], side="right")
    n = np.minimum(hi - lo, capacity)
    col = np.arange(capacity)
    valid = col[None] < n[:, None]
    src = np.where(valid, lo[:, None] + col[None], 0)
    return dict(x=np.where(valid, x[src], 0).astype(np.int32),
                y=np.where(valid, y[src], 0).astype(np.int32),
                t=np.where(valid, t[src], 0.0), p=valid & p[src],
                valid=valid, dropped=(hi - lo - n).astype(np.int32))


@dataclasses.dataclass
class Stream:
    """One period of framed stereo events, replayed in laps; a run starts
    at tick `start` (its phase in the period)."""
    period: float
    tick: float
    ticks: int                 # ticks a period
    frames: tuple              # (left, right) dicts of (ticks, cap) arrays
    points: np.ndarray
    scale: float
    start: int = 0
    _lap: int = dataclasses.field(default=-1, repr=False)
    _t: tuple = dataclasses.field(default=(), repr=False)

    def tick_time(self, i: int) -> float:
        """Time of global tick i (0-based): lap i // ticks."""
        return (i // self.ticks) * self.period \
            + (i % self.ticks + 1) * self.tick

    def ticks_at(self, i0: int, n: int) -> tuple:
        """Ticks i0 .. i0+n-1 as (t_syncs float64, left, right), each a
        dict of (n, cap) arrays with t shifted to its lap (float32): views
        of one lap's arrays where the ticks lie in one lap."""
        k0, lap = i0 % self.ticks, i0 // self.ticks
        if k0 + n > self.ticks:
            head = self.ticks_at(i0, self.ticks - k0)
            tail = self.ticks_at(i0 + self.ticks - k0, n - self.ticks + k0)
            return (np.concatenate([head[0], tail[0]]),
                    *({k: np.concatenate([a[k], b[k]]) for k in a}
                      for a, b in zip(head[1:], tail[1:])))
        sl = slice(k0, k0 + n)
        t_syncs = lap * self.period + np.arange(k0 + 1, k0 + n + 1) \
            * self.tick
        return (t_syncs, *({key: f[key][sl] for key in
                            ("x", "y", "p", "valid")} | {"t": t[sl]}
                           for f, t in zip(self.frames, self._lap_t(lap))))

    def _lap_t(self, lap: int) -> tuple:
        """Both cameras' event times of one lap, float32 (the newest lap
        kept: a run moves through the laps in order)."""
        if self._lap != lap:
            off = lap * self.period
            self._t = tuple(np.where(f["valid"], f["t"] + off, 0.0).astype(
                np.float32) for f in self.frames)
            self._lap = lap
        return self._t

    def gt_pose(self, t: float) -> np.ndarray:
        return pose_at(t % self.period, self.period, self.scale)

    def events_per_s(self) -> list:
        """Valid events a camera a second, as framed."""
        return [float(f["valid"].sum()) / self.period for f in self.frames]


def make_stream(cfg: dict, traffic: dict, seed: int,
                inv_maps: list, masks: list) -> Stream:
    """A scene of the configuration's size, drawn from `seed`, over one
    period of the traffic, both cameras framed at the configuration's
    capacity; `seed` also picks the tick of the period the run starts
    at. inv_maps / masks: each camera's (H, W, 2) float64 inverse
    rectification map and (H, W) mask."""
    sc, rig = cfg["scene"], cfg["rig"]
    period, tick = traffic["period_s"], traffic["tick_s"]
    ticks = int(round(period / tick))
    pts = edge_points(np.random.default_rng([seed, 5]), sc["points"],
                      sc["scale"])
    steps = int(round((period + traffic["warmup_s"]) / tick)) \
        * traffic["substeps"] + 1
    times = np.linspace(-traffic["warmup_s"], period, steps)
    poses = pose_at(times, period, sc["scale"])
    P_cams = [np.asarray(rp["P"]) for rp in (rig_params(rig)["left"],
                                             rig_params(rig)["right"])]
    evs = simulate(pts, times, poses, P_cams, rig["width"], rig["height"],
                   sc["threshold"])
    edges = np.arange(ticks + 1) * tick
    frames = []
    for ev, inv, mask in zip(evs, inv_maps, masks):
        t, x, y, p = to_raw(ev, inv, mask)
        keep = (t > 0.0) & (t <= period)
        frames.append(frame((t[keep], x[keep], y[keep], p[keep]), edges,
                            cfg["capacity"]))
    start = int(np.random.default_rng([seed, 3]).integers(ticks))
    return Stream(period=period, tick=tick, ticks=ticks,
                  frames=tuple(frames), points=pts, scale=sc["scale"],
                  start=start)


def check_seam(stream: Stream) -> dict:
    """The lap seam: the trajectory repeats (pose and velocity at 0 and
    at one period agree), and the first ticks of a lap carry as many
    events as the last ones (no gap, no double frame)."""
    p, h = stream.period, 1e-4
    gap = max(np.abs(pose_at(0.0, p, stream.scale)
                     - pose_at(p, p, stream.scale)).max(),
              np.abs((pose_at(p + h, p, stream.scale)
                      - pose_at(p - h, p, stream.scale))
                     - (pose_at(h, p, stream.scale)
                        - pose_at(-h, p, stream.scale))).max())
    counts = stream.frames[0]["valid"].sum(1)
    head, tail = counts[:5].mean(), counts[-5:].mean()
    ratio = float(head / max(tail, 1.0))
    res = dict(pose_gap=float(gap), head_tail_events=ratio)
    if not (gap < 1e-9 and 0.5 < ratio < 2.0):
        raise RuntimeError(f"the lap seam is not continuous: {res}")
    return res
