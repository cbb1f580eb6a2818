"""ROS-free event ingestion and fixed-capacity framing (numpy-only copy
of esvo_tpu/io/events.py, kept here so the port imports nothing of the
JAX package).

Replaces the reference's ROS event transport and the offline
``events_repacking_helper`` (events_repacking_helper/src/
EventMessageEditor.cpp:95-121): instead of re-chunking rosbag messages at
1000 Hz so callbacks stay fresh, events are packed host-side into dense
per-sync-tick frames of a fixed capacity — the shape the device programs
consume (esvo_tpu_torch.surface.time_surface.EventBatch).

Supported sources:
- rpg/upenn DAVIS text format `t x y polarity` per line (the datasets
  referenced in README.md:86),
- in-memory NumPy arrays (synthetic generator, converters).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class EventArray:
    """Host-side packed event stream (sorted by time).

    `t` must be relative to the stream origin (small values): downstream
    device code casts to float32, whose resolution at epoch scale (~1.4e9 s)
    is ~128 s — enough to collapse time-surface decay entirely. `t_offset`
    records the absolute time of the origin so trajectories can be exported
    in absolute time.
    """
    t: np.ndarray  # (N,) float64 seconds, relative to stream origin
    x: np.ndarray  # (N,) int32
    y: np.ndarray  # (N,) int32
    p: np.ndarray  # (N,) bool
    t_offset: float = 0.0  # absolute time of the stream origin

    def __post_init__(self):
        assert self.t.ndim == 1
        assert len(self.t) == len(self.x) == len(self.y) == len(self.p)

    def __len__(self):
        return len(self.t)

    def rebased(self, origin: float | None = None) -> "EventArray":
        """Rebase t to `origin` (absolute), folding the shift into
        t_offset. origin=None rebases to this stream's own first event —
        NOT safe for stereo pairs whose first events differ: rebase both
        cameras with one shared origin (the stereo loaders in
        io/datasets.py do)."""
        if origin is None:
            if len(self.t) == 0 or abs(float(self.t[0])) < 1e3:
                return self
            origin = float(self.t[0])
        return EventArray(self.t - origin, self.x, self.y, self.p,
                          t_offset=self.t_offset + origin)

    def slice_time(self, t0: float, t1: float) -> "EventArray":
        """Events with t in (t0, t1]."""
        lo = np.searchsorted(self.t, t0, side="right")
        hi = np.searchsorted(self.t, t1, side="right")
        return EventArray(self.t[lo:hi], self.x[lo:hi], self.y[lo:hi],
                          self.p[lo:hi], t_offset=self.t_offset)


def save_events_npz(path: str, ev: EventArray) -> None:
    """Write a packed binary event bundle (fast reload via load_events_npz)."""
    np.savez(path, t=ev.t, x=ev.x, y=ev.y, p=ev.p,
             t_offset=np.float64(ev.t_offset))


def load_events_npz(path: str) -> EventArray:
    """Load a bundle written by save_events_npz."""
    d = np.load(path)
    return EventArray(t=d["t"], x=d["x"], y=d["y"], p=d["p"],
                      t_offset=float(d["t_offset"]))


def load_events_txt(path: str, max_events: int | None = None) -> EventArray:
    """Load a DAVIS `events.txt` (t x y p per line)."""
    data = np.loadtxt(path, dtype=np.float64,
                      max_rows=max_events)
    if data.ndim == 1:
        data = data[None, :]
    return EventArray(t=data[:, 0].astype(np.float64),
                      x=data[:, 1].astype(np.int32),
                      y=data[:, 2].astype(np.int32),
                      p=data[:, 3] > 0.5)


def frame_events(ev: EventArray, sync_times: np.ndarray,
                 capacity: int):
    """Pack events into K fixed-capacity frames: frame k holds the events
    in (sync_times[k-1], sync_times[k]] (frame 0 takes everything up to
    sync_times[0]). Overflow beyond `capacity` is dropped newest-last
    (mirrors the reference's PROCESS_EVENT_NUM cap,
    esvo_Mapping.cpp:282-304).

    Returns dict of arrays with leading axis K:
      x, y (int32), t (float32), p (bool), valid (bool), plus
      `dropped` (K,) int32 overflow counts.
    """
    if len(ev.t) and abs(float(ev.t[0])) >= 1e6:
        raise ValueError(
            "frame_events: timestamps look absolute (t[0]="
            f"{float(ev.t[0]):.3e}); float32 framing would collapse "
            "time-surface decay. Rebase first (EventArray.rebased()).")
    K = len(sync_times)
    x = np.zeros((K, capacity), np.int32)
    y = np.zeros((K, capacity), np.int32)
    t = np.zeros((K, capacity), np.float32)
    p = np.zeros((K, capacity), bool)
    valid = np.zeros((K, capacity), bool)
    dropped = np.zeros((K,), np.int32)
    prev = -np.inf
    for k, ts in enumerate(sync_times):
        sl = ev.slice_time(prev, ts)
        n = min(len(sl), capacity)
        dropped[k] = len(sl) - n
        x[k, :n] = sl.x[:n]
        y[k, :n] = sl.y[:n]
        t[k, :n] = sl.t[:n]
        p[k, :n] = sl.p[:n]
        valid[k, :n] = True
        prev = ts
    return dict(x=x, y=y, t=t, p=p, valid=valid, dropped=dropped)
