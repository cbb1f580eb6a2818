"""The port's loaders (io/datasets.py, io/rosbag.py, io/native.py) and
scripts/torch_repack_bag.py against the JAX package's, bit for bit, on
fixtures the tests write: rpg text directories and their .npz cache,
MVSEC and DSEC hdf5 files, rosbags (read, write, repack, errors), and the
camera rig from a bag's camera_info (float64 LUTs within 1e-5 px). The native
loader is built into a temporary directory and held against the Python
path.
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esvo_tpu.io import datasets as jds
from esvo_tpu.io import rosbag as jbag
from esvo_tpu.io.events import EventArray as JEventArray
from esvo_tpu_torch.io import datasets as tds
from esvo_tpu_torch.io import native as tnative
from esvo_tpu_torch.io import rosbag as tbag
from esvo_tpu_torch.io.events import EventArray, frame_events, load_events_txt
from test_rosbag import (_camera_info_msg, _connection, _event_array_msg,
                         _message, _pose_msg, _write_bag)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_same_events(a, b):
    for name in ("t", "x", "y", "p"):
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert a.t_offset == b.t_offset


def assert_same_tuple(a, b):
    for x, y in zip(a, b):
        if hasattr(x, "t"):
            assert_same_events(x, y)
        elif x is None:
            assert y is None
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _rpg_dir(path, rng, n=400):
    for side in ("left", "right"):
        with open(path / f"events_{side}.txt", "w") as f:
            for ti in np.sort(rng.uniform(0, 1, n)):
                f.write(f"{ti:.9f} {rng.integers(0, 240)} "
                        f"{rng.integers(0, 180)} {rng.integers(0, 2)}\n")
    with open(path / "groundtruth.txt", "w") as f:
        f.write("0.0 0 0 0 0 0 0 1\n1.0 1 0 0 0 0.0998 0 0.995\n")


def test_rpg_dataset_and_cache_match_jax(tmp_path):
    _rpg_dir(tmp_path, np.random.default_rng(2))
    for kw in ({}, {"max_events": 120}):
        assert_same_tuple(tds.load_rpg_dataset(str(tmp_path), **kw),
                          jds.load_rpg_dataset(str(tmp_path), **kw))
    # cache=True: the port writes the bundles, both packages reload them
    first = tds.load_rpg_dataset(str(tmp_path), cache=True)
    assert (tmp_path / "events_left.txt.npz").exists()
    for kw in ({"cache": True}, {"cache": True, "max_events": 20}):
        assert_same_tuple(tds.load_rpg_dataset(str(tmp_path), **kw),
                          jds.load_rpg_dataset(str(tmp_path), **kw))
    assert_same_tuple(first, jds.load_rpg_dataset(str(tmp_path)))
    # an npz-only directory (no txt beside it)
    for side in ("left", "right"):
        os.replace(tmp_path / f"events_{side}.txt.npz",
                   tmp_path / f"events_{side}.npz")
        os.remove(tmp_path / f"events_{side}.txt")
    assert_same_tuple(tds.load_rpg_dataset(str(tmp_path), max_events=50),
                      jds.load_rpg_dataset(str(tmp_path), max_events=50))


def test_mvsec_and_dsec_match_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(0)
    n = 300
    path = str(tmp_path / "data.hdf5")
    gt = str(tmp_path / "gt.hdf5")
    with h5py.File(path, "w") as f:
        for cam, t0 in (("left", 1.4e9 + 0.2), ("right", 1.4e9)):
            ev = np.zeros((n, 4))
            ev[:, 0] = rng.integers(0, 346, n)
            ev[:, 1] = rng.integers(0, 260, n)
            ev[:, 2] = np.sort(rng.uniform(t0, t0 + 1.0, n))
            ev[:, 3] = rng.choice([-1.0, 1.0], n)
            f.create_dataset(f"davis/{cam}/events", data=ev)
    with h5py.File(gt, "w") as f:
        f.create_dataset("davis/left/pose", data=np.tile(np.eye(4), (5, 1, 1)))
        f.create_dataset("davis/left/pose_ts", data=np.arange(5.0))
    assert_same_events(tds.load_mvsec_events(path, "right", 100),
                       jds.load_mvsec_events(path, "right", 100))
    assert_same_tuple(tds.load_mvsec_stereo(path),
                      jds.load_mvsec_stereo(path))
    assert_same_tuple(tds.load_mvsec_gt_poses(gt),
                      jds.load_mvsec_gt_poses(gt))

    files = []
    for side, off in (("left", 5_000_000), ("right", 5_000_300)):
        p = str(tmp_path / f"{side}.h5")
        with h5py.File(p, "w") as f:
            f.create_dataset("events/x", data=rng.integers(0, 640, n))
            f.create_dataset("events/y", data=rng.integers(0, 480, n))
            f.create_dataset("events/t", data=np.sort(
                rng.integers(0, 1_000_000, n)).astype(np.int64))
            f.create_dataset("events/p", data=rng.integers(0, 2, n))
            f.create_dataset("t_offset", data=np.int64(off))
        files.append(p)
    assert_same_events(tds.load_dsec_events(files[0], max_events=150),
                       jds.load_dsec_events(files[0], max_events=150))
    assert_same_tuple(tds.load_dsec_stereo(*files, max_events=200),
                      jds.load_dsec_stereo(*files, max_events=200))


@pytest.fixture(params=["none", "bz2"])
def stereo_bag(request, tmp_path):
    """tests/test_rosbag.py's two-chunk stereo bag with a pose topic."""
    rng = np.random.default_rng(0)
    n, t0 = 200, 1468941032.0
    tl = np.sort(t0 + rng.uniform(0, 0.5, n))
    tr = np.sort(t0 + 0.003 + rng.uniform(0, 0.5, n))
    xl, yl = rng.integers(0, 240, n), rng.integers(0, 180, n)
    pl = rng.random(n) > 0.5
    half = [slice(0, 100), slice(100, n)]
    chunks = []
    for i, s in enumerate(half):
        head = (_connection(0, "/davis/left/events", "dvs_msgs/EventArray")
                + _connection(1, "/davis/right/events",
                              "dvs_msgs/EventArray")
                + _connection(2, "/optitrack/davis",
                              "geometry_msgs/PoseStamped")) if i == 0 else b""
        chunks.append(
            head + _message(0, _event_array_msg(tl[s], xl[s], yl[s], pl[s]))
            + _message(1, _event_array_msg(tr[s], xl[s], yl[s], pl[s]))
            + _message(2, _pose_msg(t0 + 0.5 * i, (1.0 + 0.5 * i, 2.0, 3.0),
                                    (0, 0, np.sin(0.1 * i),
                                     np.cos(0.1 * i)))))
    path = str(tmp_path / f"stereo_{request.param}.bag")
    _write_bag(path, chunks, request.param)
    return path


def test_bag_reader_matches_jax(stereo_bag):
    tb, jb = tbag.BagReader(stereo_bag), jbag.BagReader(stereo_bag)
    assert tb.topics == jb.topics == {"/davis/left/events": 2,
                                      "/davis/right/events": 2,
                                      "/optitrack/davis": 2}
    for topic in tb.topics:
        assert tb.topic_type(topic) == jb.topic_type(topic)
    for topic in ("/davis/left/events", "/davis/right/events"):
        assert_same_events(tb.events(topic), jb.events(topic))
    assert_same_tuple(tb.poses("/optitrack/davis"),
                      jb.poses("/optitrack/davis"))
    # one shared origin for both streams and the ground truth
    for kw in ({"gt_topic": "/optitrack/davis"}, {"max_events": 50}):
        got = tbag.load_stereo_bag(stereo_bag, **kw)
        assert_same_tuple(got, jbag.load_stereo_bag(stereo_bag, **kw))
    assert abs(float(got[0].t[0])) < 1e-6
    for mod in (tbag, jbag):
        with pytest.raises(KeyError, match="davis/left"):
            mod.BagReader(stereo_bag).events("/nonexistent")


def test_not_a_bag(tmp_path):
    p = tmp_path / "x.bag"
    p.write_bytes(b"hello world, definitely not a bag")
    with pytest.raises(ValueError, match="not a rosbag"):
        tbag.BagReader(str(p))


def test_rig_from_camera_info_matches_jax(tmp_path):
    """A distorted, rectified pair: the port's rig (on the CPU) against
    JAX's in float64, LUTs and inverse maps within 1e-5 px; the default
    float32 rig within float32 resolution of it."""
    W, H, FX, BASE = 240, 180, 150.0, 0.1
    K = [[FX, 0, W / 2 - 0.3], [0, FX * 1.01, H / 2 + 0.4], [0, 0, 1]]
    c, s = np.cos(0.01), np.sin(0.01)
    R = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    P_l = [[FX, 0, W / 2, 0], [0, FX, H / 2, 0], [0, 0, 1, 0]]
    P_r = [[FX, 0, W / 2, -FX * BASE], [0, FX, H / 2, 0], [0, 0, 1, 0]]
    D = [-0.2, 0.05, 1e-3, -5e-4]
    inner = (
        _connection(0, "/davis/left/camera_info", "sensor_msgs/CameraInfo")
        + _connection(1, "/davis/right/camera_info",
                      "sensor_msgs/CameraInfo")
        + _message(0, _camera_info_msg(W, H, "plumb_bob", D, K, R, P_l))
        + _message(1, _camera_info_msg(W, H, "plumb_bob", D, K, R, P_r)))
    path = str(tmp_path / "calib.bag")
    _write_bag(path, [inner])
    rt = tbag.load_rig_from_bag(path, dtype=torch.float64, device="cpu")
    rj = jbag.load_rig_from_bag(path, dtype=jnp.float64)
    assert rt.left.lut.device.type == "cpu"
    assert (rt.left.width, rt.left.height) == (W, H)
    np.testing.assert_allclose(float(rt.baseline), float(rj.baseline),
                               rtol=1e-7)
    np.testing.assert_allclose(rt.T_right_left.numpy(),
                               np.asarray(rj.T_right_left), atol=1e-7)
    for side in ("left", "right"):
        ct, cj = getattr(rt, side), getattr(rj, side)
        for name in ("K", "D", "R", "P"):
            np.testing.assert_array_equal(getattr(ct.params, name).numpy(),
                                          np.asarray(getattr(cj.params,
                                                             name)))
        np.testing.assert_allclose(ct.lut.numpy(), np.asarray(cj.lut),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(ct.inv_map.numpy(),
                                   np.asarray(cj.inv_map), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(ct.mask.numpy(), np.asarray(cj.mask))
    # the default float32 rig: its undistortion rounds in float32
    # (resolution 1.5e-5 px above 128 px), a few ulps off the float64 one
    r32 = tbag.load_rig_from_bag(path, device="cpu")
    assert r32.left.lut.dtype == torch.float32
    np.testing.assert_allclose(r32.left.lut.numpy(), rt.left.lut.numpy(),
                               rtol=0, atol=5e-5)


def _hot_stream(rng, n=5000):
    t = np.sort(1000.0 + rng.uniform(0, 0.05, n + 500))
    x = np.concatenate([rng.integers(0, 346, n), np.full(500, 100)])
    y = np.concatenate([rng.integers(0, 260, n), np.full(500, 50)])
    order = rng.permutation(n + 500)
    return (t, x[order].astype(np.int32), y[order].astype(np.int32),
            rng.random(n + 500) > 0.5)


def test_write_bag_and_hot_pixels_match_jax(tmp_path):
    t, x, y, p = _hot_stream(np.random.default_rng(2))
    ev_t, ev_j = EventArray(t, x, y, p), JEventArray(t, x, y, p)
    keep = tbag.hot_pixel_mask(ev_t, 260, 346)
    np.testing.assert_array_equal(keep, jbag.hot_pixel_mask(ev_j, 260, 346))
    assert not keep[(x == 100) & (y == 50)].any() and keep.sum() >= 4950
    paths = [str(tmp_path / f"{name}.bag") for name in ("t", "j")]
    tbag.write_events_bag(paths[0], {"/davis/left/events": ev_t}, 1e-3)
    jbag.write_events_bag(paths[1], {"/davis/left/events": ev_j}, 1e-3)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    back = tbag.BagReader(paths[0]).events("/davis/left/events")
    np.testing.assert_allclose(back.t, t, atol=2e-9)
    np.testing.assert_array_equal(back.x, x)


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_repack_cli_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    n, t0 = 400, 500.0
    tl = np.sort(t0 + rng.uniform(0, 0.02, n))
    inner = (_connection(0, "/davis/left/events", "dvs_msgs/EventArray")
             + _connection(1, "/davis/right/events", "dvs_msgs/EventArray")
             + _message(0, _event_array_msg(
                 tl, rng.integers(0, 346, n), rng.integers(0, 260, n),
                 rng.random(n) > 0.5))
             + _message(1, _event_array_msg(
                 tl, rng.integers(0, 346, n), rng.integers(0, 260, n),
                 rng.random(n) > 0.5)))
    src = str(tmp_path / "src.bag")
    _write_bag(src, [inner], "bz2")
    outs = [str(tmp_path / f"{name}.bag") for name in ("t", "j")]
    for name, out in zip(("torch_repack_bag", "repack_bag"), outs):
        _load_script(name).main([src, out, "--period-ms", "1",
                                 "--filter-hot-pixels"])
    with open(outs[0], "rb") as a, open(outs[1], "rb") as b:
        assert a.read() == b.read()
    assert tbag.BagReader(outs[0]).topics["/davis/left/events"] >= 15


def test_native_loader_matches_python(tmp_path):
    """The native library, built into a temporary directory, against the
    Python parser and framer; nothing is written under native/."""
    rng = np.random.default_rng(4)
    path = tmp_path / "events.txt"
    t = np.sort(rng.uniform(0, 0.3, 3000))
    with open(path, "w") as f:
        for ti in t:
            f.write(f"{ti:.9f} {rng.integers(0, 240)} {rng.integers(0, 180)} "
                    f"{rng.integers(0, 2)}\n")
    before = sorted(os.listdir(os.path.join(ROOT, "native")))
    loader = tnative.NativeLoader(build_dir=tmp_path / "build")
    lib = loader.lib()
    if lib is None:
        pytest.skip("no g++ on this machine: the Python path serves")
    assert loader.library_path().parent == tmp_path / "build"
    assert sorted(os.listdir(os.path.join(ROOT, "native"))) == before
    for cap in (None, 1000):
        assert_same_events(
            tnative.load_events_native(str(path), cap, loader=loader),
            load_events_txt(str(path), cap))
    ev = load_events_txt(str(path))
    ticks = np.arange(0.01, 0.3, 0.01)
    got = tnative.frame_events_native(ev, ticks, 150, loader=loader)
    want = frame_events(ev, ticks, 150)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    with pytest.raises(ValueError, match="absolute"):
        tnative.frame_events_native(
            EventArray(ev.t + 1.4e9, ev.x, ev.y, ev.p), ticks, 150,
            loader=loader)
