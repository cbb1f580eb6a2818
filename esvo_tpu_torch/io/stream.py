"""Streaming event framing with background prefetch (numpy-only copy of
esvo_tpu/io/stream.py, kept here so the port imports nothing of the JAX
package).

`frame_events` (io/events.py) materializes every tick frame up front:
K x capacity x 13 bytes, ~3 GB for one minute of DSEC stream at the
reference's 100 Hz sync rate and PROCESS_EVENT_NUM=10000 x4 capacity
(cfg/mapping/mapping_dsec.yaml). The reference never holds that much
because its ROS callbacks consume events incrementally
(esvo_Mapping.cpp:607-644 keeps a bounded deque).

`EventFrameStream` is the loader the runtime loop wants:

- one vectorized `np.searchsorted` over all sync times up front,
- frames built lazily, O(capacity) memory per in-flight frame,
- a daemon prefetch thread keeps `prefetch` frames ahead of the
  consumer, so host-side framing overlaps device work,
- `rolls(R)` yields stacked R-tick batches for `EsvoSystem.process_ticks`
  rolls and `ResidentLoop.run` dispatches.

Output frames are exactly `frame_events`' dict layout (tested element
for element in tests/test_torch_resident.py).
"""
from __future__ import annotations

import queue
import threading

import numpy as np

from esvo_tpu_torch.io.events import EventArray


class EventFrameStream:
    """Iterate fixed-capacity per-tick event frames over a sorted stream.

    Frame k holds the events in (sync_times[k-1], sync_times[k]]
    (frame 0: everything up to sync_times[0]); overflow beyond
    `capacity` is dropped newest-last, mirroring the reference's
    PROCESS_EVENT_NUM cap (esvo_Mapping.cpp:282-304).
    """

    def __init__(self, ev: EventArray, sync_times: np.ndarray,
                 capacity: int, prefetch: int = 2):
        if len(ev.t) and abs(float(ev.t[0])) >= 1e6:
            raise ValueError(
                "EventFrameStream: timestamps look absolute (t[0]="
                f"{float(ev.t[0]):.3e}); rebase first "
                "(EventArray.rebased()).")
        self.ev = ev
        self.sync_times = np.asarray(sync_times, np.float64)
        self.capacity = int(capacity)
        self.prefetch = max(int(prefetch), 0)
        # frame k covers bounds[k] : bounds[k+1] in the event arrays
        hi = np.searchsorted(ev.t, self.sync_times, side="right")
        self._bounds = np.concatenate([[0], hi]).astype(np.int64)

    def __len__(self):
        return len(self.sync_times)

    @property
    def total_dropped(self) -> int:
        counts = np.diff(self._bounds)
        return int(np.maximum(counts - self.capacity, 0).sum())

    def frame(self, k: int) -> dict:
        """Build frame k (same layout as io.events.frame_events[k])."""
        cap = self.capacity
        lo, hi = int(self._bounds[k]), int(self._bounds[k + 1])
        n = min(hi - lo, cap)
        out = dict(x=np.zeros(cap, np.int32), y=np.zeros(cap, np.int32),
                   t=np.zeros(cap, np.float32), p=np.zeros(cap, bool),
                   valid=np.zeros(cap, bool),
                   dropped=np.int32(hi - lo - n))
        ev = self.ev
        out["x"][:n] = ev.x[lo:lo + n]
        out["y"][:n] = ev.y[lo:lo + n]
        out["t"][:n] = ev.t[lo:lo + n]
        out["p"][:n] = ev.p[lo:lo + n]
        out["valid"][:n] = True
        return out

    def roll(self, k0: int, R: int) -> dict:
        """Frames k0 .. k0+R-1 stacked on a leading axis (for
        EsvoSystem.process_ticks)."""
        frames = [self.frame(k) for k in range(k0, k0 + R)]
        return {key: np.stack([f[key] for f in frames])
                for key in frames[0]}

    def _iter_prefetched(self, make, count):
        """Yield make(i) for i in range(count) with a daemon thread
        building up to `prefetch` items ahead."""
        if self.prefetch == 0:
            for i in range(count):
                yield make(i)
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            try:
                for i in range(count):
                    if stop.is_set():
                        return
                    q.put(make(i))
                q.put(None)
            except BaseException as e:       # surface in the consumer
                q.put(e)

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # unblock a producer stuck on a full queue
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break

    def __iter__(self):
        """Yield (sync_time, frame) pairs with background prefetch."""
        times = self.sync_times
        return self._iter_prefetched(
            lambda k: (float(times[k]), self.frame(k)), len(times))

    def rolls(self, R: int):
        """Yield (sync_times (R,), stacked frames) roll batches; a final
        partial roll is yielded with its true (shorter) length."""
        times = self.sync_times
        K = len(times)
        starts = list(range(0, K, R))

        def make(i):
            k0 = starts[i]
            r = min(R, K - k0)
            return times[k0:k0 + r], self.roll(k0, r)

        return self._iter_prefetched(make, len(starts))
