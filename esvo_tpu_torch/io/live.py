"""Live event ingestion over a TCP socket, the DV-driver analogue (copy of
esvo_tpu/io/live.py, which imports nothing of JAX).

The reference integrates the iniVation DV driver for live cameras
(reference README.md:245-256: events stream from the sensor process into
the ROS graph at up to 200 fps on a Jetson). This framework is ROS-free;
the live path is a plain TCP stream of packed event packets feeding the
same fixed-capacity tick framing the offline loaders produce, so
`EsvoSystem.process_tick[s]` / the resident loop consume a live camera
exactly like a dataset replay (scripts/torch_run_live.py wires it up).

Wire protocol (one stream per camera; little-endian):
    packet := magic b"EVS1" | uint32 count | count * record
    record := float64 t_seconds | uint16 x | uint16 y | uint8 polarity
A sender closes the socket at end-of-stream. `serve_event_stream` is the
reference sender (replays a recorded EventArray, optionally paced to
wall-clock — the stand-in for a sensor driver in tests/demos); any
process emitting this framing (e.g. a C driver shim around libcaer/DV)
plugs in unchanged.

`LiveEventStream` buffers arriving packets on a reader thread (bounded,
drop-oldest beyond `max_buffer_events` — the reference's 5M event-queue
cap, esvo_time_surface/src/TimeSurface.cpp:427-435) and serves
`next_frame(t_sync, capacity)`: the fixed-capacity frame of events in
(prev_sync, t_sync], blocking until the stream has advanced past t_sync
(or EOF). Frames are exactly `io.events.frame_events`'s per-tick layout.
"""
from __future__ import annotations

import socket
import struct
import threading
import time
from collections import deque

import numpy as np

MAGIC = b"EVS1"
_REC = struct.Struct("<dHHB")
_HDR = struct.Struct("<4sI")


def serve_event_stream(ev, host: str = "127.0.0.1", port: int = 0,
                       packet_events: int = 1024,
                       pace: float | None = None):
    """Serve one EventArray on a TCP socket (single client).

    pace: None streams as fast as the socket drains; a number plays the
    stream at that multiple of real time (1.0 = sensor-rate replay).
    Returns (bound_port, thread); the thread exits after serving one
    client to completion.
    """
    srv = socket.create_server((host, port))
    bound_port = srv.getsockname()[1]

    def run():
        conn, _ = srv.accept()
        try:
            t0_wall = time.perf_counter()
            t0_ev = float(ev.t[0]) if len(ev.t) else 0.0
            n = len(ev.t)
            for s in range(0, n, packet_events):
                e = min(s + packet_events, n)
                if pace is not None:
                    target = (float(ev.t[e - 1]) - t0_ev) / pace
                    lag = target - (time.perf_counter() - t0_wall)
                    if lag > 0:
                        time.sleep(lag)
                recs = b"".join(
                    _REC.pack(float(ev.t[i]), int(ev.x[i]), int(ev.y[i]),
                              int(bool(ev.p[i])))
                    for i in range(s, e))
                conn.sendall(_HDR.pack(MAGIC, e - s) + recs)
        finally:
            conn.close()
            srv.close()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return bound_port, th


class LiveEventStream:
    """Background-buffered live event source (one camera)."""

    def __init__(self, host: str, port: int,
                 max_buffer_events: int = 5_000_000,
                 connect_timeout: float = 10.0):
        self._sock = socket.create_connection((host, port),
                                              timeout=connect_timeout)
        self._sock.settimeout(None)
        self._chunks: deque = deque()      # (t, x, y, p) numpy chunks
        self._buffered = 0
        self.dropped_oldest = 0
        self._latest_t = -np.inf
        self._eof = False
        self._cv = threading.Condition()
        self._max = int(max_buffer_events)
        self._prev_sync = -np.inf
        self._thread = threading.Thread(target=self._reader, daemon=True)
        self._thread.start()

    # -- reader thread ---------------------------------------------------
    def _recv_exact(self, n: int) -> bytes | None:
        buf = bytearray()
        while len(buf) < n:
            part = self._sock.recv(n - len(buf))
            if not part:
                return None
            buf += part
        return bytes(buf)

    def _reader(self):
        try:
            while True:
                hdr = self._recv_exact(_HDR.size)
                if hdr is None:
                    break
                magic, count = _HDR.unpack(hdr)
                if magic != MAGIC:
                    raise IOError(f"bad packet magic {magic!r}")
                payload = self._recv_exact(count * _REC.size)
                if payload is None:
                    break
                a = np.frombuffer(payload, dtype=np.dtype(
                    [("t", "<f8"), ("x", "<u2"), ("y", "<u2"),
                     ("p", "u1")]))
                with self._cv:
                    self._chunks.append(
                        (a["t"].astype(np.float64),
                         a["x"].astype(np.int32),
                         a["y"].astype(np.int32),
                         a["p"].astype(bool)))
                    self._buffered += count
                    self._latest_t = float(a["t"][-1]) if count else \
                        self._latest_t
                    # bounded buffer: drop oldest whole chunks
                    while self._buffered > self._max \
                            and len(self._chunks) > 1:
                        old = self._chunks.popleft()
                        self._buffered -= len(old[0])
                        self.dropped_oldest += len(old[0])
                    self._cv.notify_all()
        except OSError:
            pass
        finally:
            with self._cv:
                self._eof = True
                self._cv.notify_all()

    # -- consumer --------------------------------------------------------
    @property
    def eof(self) -> bool:
        with self._cv:
            return self._eof and not self._chunks

    def first_time(self, timeout: float = 30.0) -> float | None:
        """Timestamp of the first buffered event (blocks until one
        arrives or EOF)."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while not self._chunks and not self._eof:
                if not self._cv.wait(max(deadline - time.monotonic(),
                                         0.01)):
                    return None
                if time.monotonic() > deadline:
                    return None
            return float(self._chunks[0][0][0]) if self._chunks else None

    def next_frame(self, t_sync: float, capacity: int,
                   timeout: float = 30.0) -> dict | None:
        """Fixed-capacity frame of the events in (prev_sync, t_sync].

        Blocks until the stream is known to have advanced past t_sync
        (an event with t > t_sync arrived, or EOF). Returns None on
        timeout; at EOF returns whatever is buffered.
        """
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._latest_t <= t_sync and not self._eof:
                if not self._cv.wait(max(deadline - time.monotonic(),
                                         0.01)):
                    return None
                if time.monotonic() > deadline:
                    return None
            ts, xs, ys, ps = [], [], [], []
            while self._chunks:
                t, x, y, p = self._chunks[0]
                if t[0] > t_sync:
                    break
                if t[-1] <= t_sync:
                    self._chunks.popleft()
                    self._buffered -= len(t)
                    keep = t > self._prev_sync
                    ts.append(t[keep]); xs.append(x[keep])
                    ys.append(y[keep]); ps.append(p[keep])
                else:
                    cut = int(np.searchsorted(t, t_sync, side="right"))
                    keep = t[:cut] > self._prev_sync
                    ts.append(t[:cut][keep]); xs.append(x[:cut][keep])
                    ys.append(y[:cut][keep]); ps.append(p[:cut][keep])
                    self._chunks[0] = (t[cut:], x[cut:], y[cut:], p[cut:])
                    self._buffered -= cut
                    break
        self._prev_sync = t_sync
        t = np.concatenate(ts) if ts else np.zeros(0)
        x = np.concatenate(xs) if xs else np.zeros(0, np.int32)
        y = np.concatenate(ys) if ys else np.zeros(0, np.int32)
        p = np.concatenate(ps) if ps else np.zeros(0, bool)
        n = min(len(t), capacity)
        frame = {
            "x": np.zeros(capacity, np.int32),
            "y": np.zeros(capacity, np.int32),
            "t": np.zeros(capacity, np.float32),
            "p": np.zeros(capacity, bool),
            "valid": np.zeros(capacity, bool),
            "dropped": np.int32(len(t) - n),
        }
        frame["x"][:n] = x[:n]
        frame["y"][:n] = y[:n]
        frame["t"][:n] = t[:n]
        frame["p"][:n] = p[:n]
        frame["valid"][:n] = True
        return frame

    def close(self):
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
