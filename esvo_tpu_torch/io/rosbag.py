"""ROS-free rosbag (v2.0) reader and writer for event-camera datasets
(numpy-only copy of esvo_tpu/io/rosbag.py; ``load_rig_from_bag`` builds
this package's camera rig).

The reference's entire data pipeline is rosbag replay
(esvo_time_surface/launch/rosbag_launcher/**, README.md:86: the
rpg/upenn releases ship as .bag files; events_repacking_helper rewrites
them with the rosbag C++ API). This module reads those bags directly —
no ROS installation — so a user of the reference can point
``scripts/torch_run_dataset.py --bag`` at the same files:

- bag format v2.0 (http://wiki.ros.org/Bags/Format/2.0): length-prefixed
  records with field headers; chunks hold the message stream with
  ``none`` or ``bz2`` compression (both stdlib; ``lz4`` is gated on the
  optional lz4 package),
- ``dvs_msgs/EventArray`` messages decode to packed NumPy arrays
  (x uint16, y uint16, ts sec+nsec, polarity u8 — the exact wire layout
  the reference's callbacks consume, esvo_Mapping.cpp:690-718),
- ``geometry_msgs/PoseStamped`` decodes to (times, 4x4 poses) for
  ground-truth topics.

Everything is host-side NumPy; vectorized decoding (one frombuffer per
message, no per-event Python loop).
"""
from __future__ import annotations

import bz2
import struct

import numpy as np
import torch

from esvo_tpu_torch._device import resolve_device
from esvo_tpu_torch.geometry.camera import (PinholeParams, StereoRig,
                                            make_camera)
from esvo_tpu_torch.io.events import EventArray

_OP_BAG_HEADER = 0x03
_OP_CHUNK = 0x05
_OP_CONNECTION = 0x07
_OP_MESSAGE_DATA = 0x02
_OP_INDEX_DATA = 0x04
_OP_CHUNK_INFO = 0x06

# dvs_msgs/Event wire layout: x u16, y u16, ts (u32 sec, u32 nsec),
# polarity u8 — 13 bytes, no padding (ROS serialization is packed)
_EVENT_DTYPE = np.dtype([("x", "<u2"), ("y", "<u2"), ("sec", "<u4"),
                         ("nsec", "<u4"), ("p", "u1")])


def _read_fields(buf: bytes) -> dict:
    """Parse a record header: sequence of len(u32) 'name=value' items."""
    fields = {}
    o = 0
    n = len(buf)
    while o + 4 <= n:
        (ln,) = struct.unpack_from("<I", buf, o)
        o += 4
        item = buf[o:o + ln]
        o += ln
        eq = item.index(b"=")
        fields[item[:eq].decode()] = item[eq + 1:]
    return fields


def _iter_records(buf: bytes, offset: int = 0):
    """Yield (fields, data) records from a byte buffer."""
    o = offset
    n = len(buf)
    while o + 4 <= n:
        (hlen,) = struct.unpack_from("<I", buf, o)
        o += 4
        fields = _read_fields(buf[o:o + hlen])
        o += hlen
        (dlen,) = struct.unpack_from("<I", buf, o)
        o += 4
        data = buf[o:o + dlen]
        o += dlen
        yield fields, data


def _decompress(data: bytes, compression: str) -> bytes:
    if compression == "none":
        return data
    if compression == "bz2":
        return bz2.decompress(data)
    if compression == "lz4":
        try:
            import lz4.frame
        except ImportError as e:
            raise RuntimeError(
                "bag chunk is lz4-compressed; the optional lz4 package "
                "is not installed (rewrite the bag with rosbag compress "
                "--bz2, or install lz4)") from e
        return lz4.frame.decompress(data)
    raise ValueError(f"unknown bag compression {compression!r}")


def _decode_string(data: bytes, o: int):
    (ln,) = struct.unpack_from("<I", data, o)
    return data[o + 4:o + 4 + ln], o + 4 + ln


def _decode_event_array(data: bytes):
    """dvs_msgs/EventArray -> (t (N,) float64 abs seconds, x, y, p)."""
    # std_msgs/Header: u32 seq, u32 sec, u32 nsec, string frame_id
    o = 12
    _, o = _decode_string(data, o)
    o += 8                                      # u32 height, u32 width
    (count,) = struct.unpack_from("<I", data, o)
    o += 4
    ev = np.frombuffer(data, dtype=_EVENT_DTYPE, count=count, offset=o)
    t = ev["sec"].astype(np.float64) + ev["nsec"].astype(np.float64) * 1e-9
    return (t, ev["x"].astype(np.int32), ev["y"].astype(np.int32),
            ev["p"] > 0)


def _decode_camera_info(data: bytes):
    """sensor_msgs/CameraInfo -> dict(width, height, model, D, K, R, P)."""
    o = 12                                      # header: seq + stamp
    _, o = _decode_string(data, o)              # frame_id
    (height, width) = struct.unpack_from("<II", data, o)
    o += 8
    model_b, o = _decode_string(data, o)
    (nd,) = struct.unpack_from("<I", data, o)
    o += 4
    D = np.frombuffer(data, "<f8", count=nd, offset=o).copy()
    o += 8 * nd
    K = np.frombuffer(data, "<f8", count=9, offset=o).reshape(3, 3).copy()
    o += 72
    R = np.frombuffer(data, "<f8", count=9, offset=o).reshape(3, 3).copy()
    o += 72
    P = np.frombuffer(data, "<f8", count=12, offset=o).reshape(3, 4).copy()
    return dict(width=int(width), height=int(height),
                model=model_b.decode(), D=D, K=K, R=R, P=P)


def _decode_pose_stamped(data: bytes):
    """geometry_msgs/PoseStamped -> (t, (4, 4) pose)."""
    (sec, nsec) = struct.unpack_from("<II", data, 4)
    o = 12
    _, o = _decode_string(data, o)
    vals = struct.unpack_from("<7d", data, o)   # xyz + quat xyzw
    x, y, z, qx, qy, qz, qw = vals
    T = np.eye(4)
    n = qx * qx + qy * qy + qz * qz + qw * qw
    s = 0.0 if n < 1e-12 else 2.0 / n
    T[:3, :3] = [
        [1 - s * (qy * qy + qz * qz), s * (qx * qy - qz * qw),
         s * (qx * qz + qy * qw)],
        [s * (qx * qy + qz * qw), 1 - s * (qx * qx + qz * qz),
         s * (qy * qz - qx * qw)],
        [s * (qx * qz - qy * qw), s * (qy * qz + qx * qw),
         1 - s * (qx * qx + qy * qy)],
    ]
    T[:3, 3] = [x, y, z]
    return sec + nsec * 1e-9, T


class BagReader:
    """Random-access reader over one bag's topics of interest."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            raw = f.read()
        magic = b"#ROSBAG V2.0\n"
        if not raw.startswith(magic):
            head = raw[:13].decode(errors="replace")
            raise ValueError(f"{path}: not a rosbag v2.0 file "
                             f"(starts with {head!r})")
        self._topics: dict[int, str] = {}      # conn id -> topic
        self._types: dict[int, str] = {}       # conn id -> msg type
        # topic -> list of serialized message buffers (in stream order)
        self._messages: dict[str, list[bytes]] = {}
        for fields, data in _iter_records(raw, len(magic)):
            op = fields["op"][0]
            if op == _OP_CHUNK:
                comp = fields["compression"].decode()
                inner = _decompress(data, comp)
                for ifields, idata in _iter_records(inner):
                    self._handle(ifields, idata)
            elif op in (_OP_CONNECTION, _OP_MESSAGE_DATA):
                self._handle(fields, data)      # uncompressed bags

    def _handle(self, fields: dict, data: bytes):
        op = fields["op"][0]
        if op == _OP_CONNECTION:
            (conn,) = struct.unpack("<I", fields["conn"])
            topic = fields["topic"].decode()
            sub = _read_fields(data)
            self._topics[conn] = topic
            self._types[conn] = sub.get("type", b"").decode()
        elif op == _OP_MESSAGE_DATA:
            (conn,) = struct.unpack("<I", fields["conn"])
            topic = self._topics.get(conn, f"conn{conn}")
            self._messages.setdefault(topic, []).append(data)

    @property
    def topics(self) -> dict[str, int]:
        """topic -> message count."""
        return {t: len(m) for t, m in self._messages.items()}

    def topic_type(self, topic: str) -> str | None:
        for conn, t in self._topics.items():
            if t == topic:
                return self._types.get(conn)
        return None

    def events(self, topic: str) -> EventArray:
        """Decode a dvs_msgs/EventArray topic into one packed stream
        (absolute timestamps; rebase for framing)."""
        msgs = self._messages.get(topic)
        if not msgs:
            raise KeyError(f"topic {topic!r} not in bag; available: "
                           f"{sorted(self._messages)}")
        ts, xs, ys, ps = [], [], [], []
        for m in msgs:
            t, x, y, p = _decode_event_array(m)
            ts.append(t)
            xs.append(x)
            ys.append(y)
            ps.append(p)
        t = np.concatenate(ts) if ts else np.zeros(0)
        order = None
        if len(t) > 1 and (np.diff(t) < 0).any():
            order = np.argsort(t, kind="stable")
        out = EventArray(
            t=t if order is None else t[order],
            x=np.concatenate(xs)[order] if order is not None
            else np.concatenate(xs),
            y=np.concatenate(ys)[order] if order is not None
            else np.concatenate(ys),
            p=np.concatenate(ps)[order] if order is not None
            else np.concatenate(ps))
        return out

    def camera_info(self, topic: str) -> dict:
        """Decode the first sensor_msgs/CameraInfo message of a topic:
        dict(width, height, model, D, K, R, P)."""
        msgs = self._messages.get(topic)
        if not msgs:
            raise KeyError(f"topic {topic!r} not in bag; available: "
                           f"{sorted(self._messages)}")
        return _decode_camera_info(msgs[0])

    def poses(self, topic: str):
        """Decode a geometry_msgs/PoseStamped topic ->
        (times (N,), poses (N, 4, 4))."""
        msgs = self._messages.get(topic)
        if not msgs:
            raise KeyError(f"topic {topic!r} not in bag; available: "
                           f"{sorted(self._messages)}")
        pairs = [_decode_pose_stamped(m) for m in msgs]
        times = np.asarray([p[0] for p in pairs])
        poses = np.stack([p[1] for p in pairs])
        order = np.argsort(times, kind="stable")
        return times[order], poses[order]


def load_rig_from_bag(path_or_reader,
                      left_topic: str = "/davis/left/camera_info",
                      right_topic: str = "/davis/right/camera_info",
                      dtype=torch.float32, device=None) -> StereoRig:
    """Build a StereoRig on `device` (``cuda`` unless the caller names
    another) from a bag's camera_info topics, no calib directory needed
    (the reference publishes calibration the same way,
    rosbag_launcher/*/\\*_calib_info.launch). T_right_left is derived
    from the rectified right projection matrix (pure-baseline form,
    CameraSystem.cpp:161-166)."""
    dev = resolve_device(device)
    bag = (path_or_reader if isinstance(path_or_reader, BagReader)
           else BagReader(path_or_reader))
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    def cam(topic):
        i = bag.camera_info(topic)
        D = np.pad(i["D"][:5], (0, max(0, 5 - len(i["D"]))))
        params = PinholeParams(K=t(i["K"]), D=t(D), R=t(i["R"]),
                               P=t(i["P"]), width=i["width"],
                               height=i["height"], model=i["model"])
        return make_camera(params), i["P"]

    left, _ = cam(left_topic)
    right, Pr = cam(right_topic)
    b_vec = np.linalg.inv(Pr[:, :3]) @ Pr[:, 3]
    baseline = float(np.linalg.norm(b_vec))
    T = np.eye(4)
    T[:3, 3] = b_vec
    return StereoRig(left=left, right=right, T_right_left=t(T),
                     baseline=t(baseline))


def _w_field(name: str, value: bytes) -> bytes:
    item = name.encode() + b"=" + value
    return struct.pack("<I", len(item)) + item


def _w_record(fields: dict, data: bytes) -> bytes:
    hdr = b"".join(_w_field(k, v) for k, v in fields.items())
    return (struct.pack("<I", len(hdr)) + hdr
            + struct.pack("<I", len(data)) + data)


def _w_string(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<I", len(b)) + b


def _w_time(t: float) -> bytes:
    sec = int(t)
    return struct.pack("<II", sec, int(round((t - sec) * 1e9)))


def write_events_bag(path: str, streams: dict, period: float = 1e-3,
                     height: int = 260, width: int = 346) -> None:
    """Write a bag v2.0 with fixed-period dvs_msgs/EventArray messages.

    The events_repacking_helper counterpart
    (EventMessageEditor.cpp:95-121): re-chunks each stream into
    `period`-second messages (1 ms default = the 1000 Hz rate the
    reference requires, README.md:235) so downstream ROS consumers see
    fresh events. streams: topic -> EventArray (absolute or rebased
    timestamps; written as-is). Uncompressed chunks (~4 MB each)."""
    inner = []
    conns = []
    for conn, (topic, ev) in enumerate(streams.items()):
        sub = (_w_field("type", b"dvs_msgs/EventArray")
               + _w_field("md5sum", b"5e8beee5a6c107e504c2e78903c224b8")
               + _w_field("message_definition", b""))
        conns.append(_w_record(
            {"op": b"\x07", "conn": struct.pack("<I", conn),
             "topic": topic.encode()}, sub))
        if len(ev.t) == 0:
            continue
        t = np.asarray(ev.t, np.float64)
        edges = np.arange(t[0], t[-1] + period, period)
        bounds = np.searchsorted(t, edges, side="left")
        msgs = []
        for i in range(len(edges) - 1):
            lo, hi = int(bounds[i]), int(bounds[i + 1])
            if hi <= lo:
                continue
            sec = t[lo:hi].astype(np.int64)
            nsec = np.round((t[lo:hi] - sec) * 1e9).astype(np.int64)
            arr = np.empty(hi - lo, dtype=_EVENT_DTYPE)
            arr["x"] = ev.x[lo:hi]
            arr["y"] = ev.y[lo:hi]
            arr["sec"] = sec
            arr["nsec"] = nsec
            arr["p"] = np.asarray(ev.p[lo:hi], np.uint8)
            payload = (struct.pack("<I", i) + _w_time(float(t[lo]))
                       + _w_string("davis")
                       + struct.pack("<II", height, width)
                       + struct.pack("<I", hi - lo) + arr.tobytes())
            msgs.append(_w_record(
                {"op": b"\x02", "conn": struct.pack("<I", conn),
                 "time": _w_time(float(t[lo]))}, payload))
        inner.append((conn, msgs))

    with open(path, "wb") as f:
        f.write(b"#ROSBAG V2.0\n")
        f.write(_w_record(
            {"op": b"\x03", "index_pos": struct.pack("<Q", 0),
             "conn_count": struct.pack("<I", len(streams)),
             "chunk_count": struct.pack("<I", 1)}, b"\x00" * 4096))
        chunk = b"".join(conns)
        budget = 4 << 20
        pending = []
        size = len(chunk)

        def flush(buf):
            f.write(_w_record({"op": b"\x05", "compression": b"none",
                               "size": struct.pack("<I", len(buf))}, buf))

        for _, msgs in inner:
            for m in msgs:
                pending.append(m)
                size += len(m)
                if size >= budget:
                    flush(chunk + b"".join(pending))
                    chunk, pending, size = b"", [], 0
        if chunk or pending:
            flush(chunk + b"".join(pending))


def hot_pixel_mask(ev: EventArray, height: int, width: int,
                   sigma: float = 5.0) -> np.ndarray:
    """Per-event keep-mask removing hot pixels: pixels whose event count
    exceeds mean + sigma*std of the occupied-pixel counts (the
    events_repacking_helper README workflow step 2)."""
    idx = np.asarray(ev.y, np.int64) * width + np.asarray(ev.x, np.int64)
    counts = np.bincount(idx, minlength=height * width)
    occ = counts[counts > 0]
    if len(occ) == 0:
        return np.ones(len(ev.t), bool)
    thr = occ.mean() + sigma * occ.std()
    hot = counts > thr
    return ~hot[idx]


def load_stereo_bag(path: str,
                    left_topic: str = "/davis/left/events",
                    right_topic: str = "/davis/right/events",
                    gt_topic: str | None = None,
                    max_events: int | None = None):
    """Read a reference-format stereo bag.

    Returns (ev_left, ev_right, gt_times, gt_poses): both event streams
    rebased to ONE shared origin (stereo-synchronized, like the other
    dataset loaders); GT times in the same rebased clock.
    """
    bag = BagReader(path)
    ev_l = bag.events(left_topic)
    ev_r = bag.events(right_topic)
    origin = min(float(ev_l.t[0]) if len(ev_l) else np.inf,
                 float(ev_r.t[0]) if len(ev_r) else np.inf)
    if np.isfinite(origin):
        ev_l = ev_l.rebased(origin)
        ev_r = ev_r.rebased(origin)
    if max_events is not None:
        ev_l = EventArray(t=ev_l.t[:max_events], x=ev_l.x[:max_events],
                          y=ev_l.y[:max_events], p=ev_l.p[:max_events],
                          t_offset=ev_l.t_offset)
        ev_r = EventArray(t=ev_r.t[:max_events], x=ev_r.x[:max_events],
                          y=ev_r.y[:max_events], p=ev_r.p[:max_events],
                          t_offset=ev_r.t_offset)
    gt_times, gt_poses = None, None
    if gt_topic is not None:
        gt_times, gt_poses = bag.poses(gt_topic)
        gt_times = gt_times - (origin if np.isfinite(origin) else 0.0)
    return ev_l, ev_r, gt_times, gt_poses
