"""Live TCP event ingestion in the port (io/live.py and
scripts/torch_run_live.py): live tick frames equal the offline framer's
on the same stream (and the JAX package's live frames), a paced stream
ends cleanly at EOF, and the live runner drives the closed loop on the
CPU through ``main(argv, device="cpu")`` to WORKING.
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))

import torch_run_live  # noqa: E402
from esvo_tpu.io import live as jlive  # noqa: E402
from esvo_tpu_torch.io.events import EventArray, frame_events  # noqa: E402
from esvo_tpu_torch.io.live import (LiveEventStream,  # noqa: E402
                                    serve_event_stream)
from esvo_tpu_torch.io.synthetic import (make_scene,  # noqa: E402
                                         simulate_stereo_events)
from test_run_dataset import BASELINE, FX, H, W, _calib_yaml  # noqa: E402


def make_stream(rng, n=20000, dur=0.5):
    t = np.sort(rng.uniform(0, dur, n))
    return EventArray(t=t, x=rng.integers(0, W, n).astype(np.int16),
                      y=rng.integers(0, H, n).astype(np.int16),
                      p=rng.random(n) > 0.5, t_offset=0.0)


def test_live_frames_match_offline_framer_and_jax():
    ev = make_stream(np.random.default_rng(0))
    ticks = np.arange(0.01, 0.5, 0.01)
    ref = frame_events(ev, ticks, 600)
    streams = []
    for serve, Stream in ((serve_event_stream, LiveEventStream),
                          (jlive.serve_event_stream, jlive.LiveEventStream)):
        port, th = serve(ev, port=0)
        streams.append((Stream("127.0.0.1", port), th))
    try:
        for k, ts in enumerate(ticks):
            f, g = (s.next_frame(float(ts), 600) for s, _ in streams)
            assert f is not None and g is not None, f"timeout at tick {k}"
            for key in ("x", "y", "p", "valid"):
                np.testing.assert_array_equal(f[key], ref[key][k])
            np.testing.assert_allclose(f["t"], ref["t"][k], atol=1e-6)
            assert int(f["dropped"]) == int(ref["dropped"][k])
            for key in f:
                np.testing.assert_array_equal(f[key], g[key])
    finally:
        for s, th in streams:
            th.join(timeout=5)
            assert not th.is_alive()
            s.close()


def test_live_paced_stream_and_eof():
    ev = make_stream(np.random.default_rng(1), n=3000, dur=0.2)
    port, th = serve_event_stream(ev, port=0, pace=10.0)
    stream = LiveEventStream("127.0.0.1", port)
    got = 0
    for ts in np.arange(0.05, 0.25, 0.05):
        f = stream.next_frame(float(ts), 4000)
        assert f is not None
        got += int(f["valid"].sum())
    assert got == len(ev.t)
    assert stream.eof
    th.join(timeout=5)
    assert not th.is_alive()
    stream.close()


def test_run_live_closed_loop(tmp_path):
    """tests/test_live_stream.py's closed loop, through the port's live
    runner on two local sockets, with the live dashboard on."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    rng = np.random.default_rng(3)
    scene = make_scene(rng, num_points=4000, duration=0.5, steps=51,
                       motion_scale=0.6)
    cx, cy = W / 2 - 0.5, H / 2 - 0.5
    P_l = np.array([[FX, 0, cx, 0], [0, FX, cy, 0], [0, 0, 1, 0]])
    P_r = P_l.copy()
    P_r[0, 3] = -FX * BASELINE
    ev_l, ev_r = simulate_stereo_events(scene, P_l, P_r, W, H,
                                        pixel_threshold=0.75, rng=rng)
    calib = tmp_path / "calib"
    calib.mkdir()
    _calib_yaml(calib / "left.yaml", "l", W, H, FX, FX, cx, cy, 0.0)
    _calib_yaml(calib / "right.yaml", "r", W, H, FX, FX, cx, cy,
                -FX * BASELINE)
    pl, tl = serve_event_stream(ev_l, port=0)
    pr, tr = serve_event_stream(ev_r, port=0)
    out = str(tmp_path / "traj_live.txt")
    try:
        result = torch_run_live.main([
            "--left", f"127.0.0.1:{pl}", "--right", f"127.0.0.1:{pr}",
            "--calib", str(calib), "--duration", "0.45",
            "--set", "mapping.process_event_num=800",
            "--set", "mapping.init_sgm_num_threshold=300",
            "--set", "mapping.denoising=false",
            "--set", "mapping.regularization=false",
            "--set", "mapping.std_var_vis_threshold=0.05",
            "--set", "mapping.age_vis_threshold=0",
            "--set", "bm.zncc_threshold=0.25",
            "--live-view", "0", "--out", out, "--quiet"], device="cpu")
    finally:
        torch.set_num_threads(n_threads)
    for th in (tl, tr):
        th.join(timeout=5)
    assert result["ticks"] >= 40
    assert result["status"] == "WORKING"
    assert result["stats"]["map_points"] > 200
    assert os.path.exists(out)
    # --live-view (the dashboard, on an ephemeral port above) is wired
    assert torch_run_live.parse_args(
        ["--left", "a:1", "--right", "b:2", "--calib", "c",
         "--live-view", "9000"]).live_view == 9000
