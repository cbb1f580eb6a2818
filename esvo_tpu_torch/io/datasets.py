"""Dataset loaders for the benchmark suites the reference evaluates on
(numpy-only copy of esvo_tpu/io/datasets.py, on this package's event
arrays and native loader).

The reference consumes all data as ROS bags (README.md:86: rpg stereo DVS
bags, upenn/MVSEC bags, DSEC); ROS-free equivalents:

- rpg stereo DVS text exports: `events_left.txt`/`events_right.txt`
  (`t x y p` lines), `groundtruth.txt` (TUM `t x y z qx qy qz qw`),
  calib as ESVO-format left.yaml/right.yaml (geometry.camera.load_rig);
- MVSEC hdf5: /davis/{left,right}/events as (N, 4) [x, y, t, p] plus GT
  poses in the companion _gt.hdf5;
- DSEC hdf5: /events/{x,y,t,p} with t in microseconds offset by
  /t_offset.

Everything returns the framework's EventArray / NumPy pose tables.
"""
from __future__ import annotations

import os

import numpy as np

from esvo_tpu_torch.eval.trajectory import load_tum
from esvo_tpu_torch.io.events import (EventArray, load_events_npz,
                                      save_events_npz)
from esvo_tpu_torch.io.native import load_events_native


def load_rpg_dataset(path: str, max_events: int | None = None,
                     cache: bool = False):
    """Load an rpg-format directory: events_left.txt / events_right.txt /
    groundtruth.txt. Returns (ev_left, ev_right, gt_times, gt_poses).

    cache=True writes a packed .npz next to each txt on first load and
    memload-reloads it afterwards (the offline-conversion analogue of
    events_repacking_helper's one-time bag rewrite)."""
    ev_l = _load_txt_cached(os.path.join(path, "events_left.txt"),
                            max_events, cache)
    ev_r = _load_txt_cached(os.path.join(path, "events_right.txt"),
                            max_events, cache)
    gt_times, gt_poses = None, None
    gt_file = os.path.join(path, "groundtruth.txt")
    if os.path.exists(gt_file):
        gt_times, gt_poses = load_tum(gt_file)
    return ev_l, ev_r, gt_times, gt_poses


def _load_txt_cached(txt_path: str, max_events, cache: bool):
    # packed-binary dataset variant (e.g. the esim simulator's exports):
    # events_left.npz next to — or instead of — events_left.txt
    npz_only = txt_path[:-4] + ".npz"
    if not os.path.exists(txt_path) and os.path.exists(npz_only):
        ev = load_events_npz(npz_only)
        if max_events is not None and len(ev) > max_events:
            ev = EventArray(t=ev.t[:max_events], x=ev.x[:max_events],
                            y=ev.y[:max_events], p=ev.p[:max_events],
                            t_offset=ev.t_offset)
        return ev
    if not cache:
        return load_events_native(txt_path, max_events)
    npz = txt_path + ".npz"
    if os.path.exists(npz) and \
            os.path.getmtime(npz) >= os.path.getmtime(txt_path):
        ev = load_events_npz(npz)
    else:
        ev = load_events_native(txt_path, None)
        save_events_npz(npz, ev)
    if max_events is not None and len(ev) > max_events:
        ev = EventArray(t=ev.t[:max_events], x=ev.x[:max_events],
                        y=ev.y[:max_events], p=ev.p[:max_events],
                        t_offset=ev.t_offset)
    return ev


def load_mvsec_events(h5_path: str, camera: str = "left",
                      max_events: int | None = None,
                      origin: float | None = None) -> EventArray:
    """MVSEC data hdf5: /davis/<cam>/events rows are [x, y, t, p(-1/1)].

    MVSEC timestamps are absolute epoch seconds (~1.4e9): they are
    rebased so downstream float32 framing keeps sub-ms resolution.
    origin=None rebases to this camera's own first event — for a stereo
    pair pass one shared origin (or use load_mvsec_stereo)."""
    import h5py
    with h5py.File(h5_path, "r") as f:
        ds = f["davis"][camera]["events"]
        n = len(ds) if max_events is None else min(len(ds), max_events)
        ev = ds[:n]
    return EventArray(t=ev[:, 2].astype(np.float64),
                      x=ev[:, 0].astype(np.int32),
                      y=ev[:, 1].astype(np.int32),
                      p=ev[:, 3] > 0).rebased(origin)


def load_mvsec_stereo(h5_path: str, max_events: int | None = None):
    """Both MVSEC cameras rebased to ONE shared origin (the earlier of
    the two first events) so the stereo pair stays time-synchronized.
    Returns (ev_left, ev_right)."""
    ev_l = load_mvsec_events(h5_path, "left", max_events, origin=0.0)
    ev_r = load_mvsec_events(h5_path, "right", max_events, origin=0.0)
    origin = min(float(ev_l.t[0]) if len(ev_l) else np.inf,
                 float(ev_r.t[0]) if len(ev_r) else np.inf)
    if not np.isfinite(origin):
        return ev_l, ev_r
    return ev_l.rebased(origin), ev_r.rebased(origin)


def load_mvsec_gt_poses(gt_h5_path: str, camera: str = "left"):
    """MVSEC ground-truth hdf5: /davis/<cam>/pose (N, 4, 4) +
    pose_ts (N,). Returns (times, poses)."""
    import h5py
    with h5py.File(gt_h5_path, "r") as f:
        poses = np.asarray(f["davis"][camera]["pose"])
        times = np.asarray(f["davis"][camera]["pose_ts"])
    return times, poses


def load_dsec_events(h5_path: str,
                     max_events: int | None = None,
                     origin: float | None = None) -> EventArray:
    """DSEC event hdf5: /events/{x,y,t,p}, t in microseconds relative to
    /t_offset.

    origin=None rebases to this camera's own first event — for a stereo
    pair pass one shared origin (or use load_dsec_stereo)."""
    import h5py
    with h5py.File(h5_path, "r") as f:
        g = f["events"]
        n = len(g["t"]) if max_events is None else min(len(g["t"]),
                                                       max_events)
        t = g["t"][:n].astype(np.float64)
        if "t_offset" in f:
            t = t + float(np.asarray(f["t_offset"]))
        return EventArray(t=t * 1e-6,
                          x=g["x"][:n].astype(np.int32),
                          y=g["y"][:n].astype(np.int32),
                          p=g["p"][:n] > 0).rebased(origin)


def load_dsec_stereo(left_h5: str, right_h5: str,
                     max_events: int | None = None):
    """Both DSEC cameras rebased to ONE shared origin (the earlier of
    the two first events). Returns (ev_left, ev_right)."""
    ev_l = load_dsec_events(left_h5, max_events, origin=0.0)
    ev_r = load_dsec_events(right_h5, max_events, origin=0.0)
    origin = min(float(ev_l.t[0]) if len(ev_l) else np.inf,
                 float(ev_r.t[0]) if len(ev_r) else np.inf)
    if not np.isfinite(origin):
        return ev_l, ev_r
    return ev_l.rebased(origin), ev_r.rebased(origin)
