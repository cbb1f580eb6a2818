"""The port's live browser viewer (utils/live_view.py, a copy of the JAX
package's): tests/test_live_view.py's cases on the port's module, and
the two encoders byte for byte."""
import json
import urllib.error
import urllib.request

import numpy as np

from esvo_tpu.utils import live_view as jlv
from esvo_tpu_torch.utils.live_view import LiveViewer, encode_png
from test_live_view import decode_png_rgb


def test_png_roundtrip_and_equal_to_jax():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(17, 23, 3), dtype=np.uint8)
    assert encode_png(img) == jlv.encode_png(img)
    np.testing.assert_array_equal(decode_png_rgb(encode_png(img)), img)
    g = rng.integers(0, 256, size=(5, 9), dtype=np.uint8)
    out = decode_png_rgb(encode_png(g))
    for c in range(3):
        np.testing.assert_array_equal(out[..., c], g)


def test_http_dashboard_roundtrip():
    viewer = LiveViewer(port=0, host="127.0.0.1")
    try:
        img = np.zeros((8, 8, 3), np.uint8)
        img[2, 3] = (250, 10, 99)
        viewer.update("inv_depth", img)
        viewer.update_text("status", "WORKING tick 5")
        base = f"http://127.0.0.1:{viewer.port}"
        assert "esvo_tpu live" in urllib.request.urlopen(
            base + "/").read().decode()
        state = json.loads(urllib.request.urlopen(
            base + "/state.json").read())
        assert state == {"frames": ["inv_depth"],
                         "text": {"status": "WORKING tick 5"}}
        png = urllib.request.urlopen(base + "/frame/inv_depth.png").read()
        np.testing.assert_array_equal(decode_png_rgb(png), img)
        try:
            urllib.request.urlopen(base + "/frame/nope.png")
            raise AssertionError("expected 404")
        except urllib.error.HTTPError as e:
            assert e.code == 404
        img2 = np.full((4, 4, 3), 7, np.uint8)
        viewer.update("inv_depth", img2)
        np.testing.assert_array_equal(decode_png_rgb(urllib.request.urlopen(
            base + "/frame/inv_depth.png").read()), img2)
    finally:
        viewer.close()


def test_param_and_reset_control_channel():
    got = {"params": [], "resets": 0}

    def on_param(s):
        if "bogus" in s:
            raise ValueError(f"unknown field {s!r}")
        got["params"].append(s)
        return "queued"

    def on_reset():
        got["resets"] += 1

    v = LiveViewer(port=0, host="127.0.0.1", on_param=on_param,
                   on_reset=on_reset)
    base = f"http://127.0.0.1:{v.port}"
    try:
        req = urllib.request.Request(f"{base}/param",
                                     data=b"bm.zncc_threshold=0.3",
                                     method="POST")
        with urllib.request.urlopen(req) as r:
            assert r.status == 200 and b"queued" in r.read()
        with urllib.request.urlopen(urllib.request.Request(
                f"{base}/reset", data=b"", method="POST")) as r:
            assert r.status == 200
        try:
            urllib.request.urlopen(urllib.request.Request(
                f"{base}/param", data=b"bogus.field=1", method="POST"))
            raise AssertionError("expected 400")
        except urllib.error.HTTPError as e:
            assert e.code == 400 and b"unknown field" in e.read()
        assert got == {"params": ["bm.zncc_threshold=0.3"], "resets": 1}
        with urllib.request.urlopen(f"{base}/") as r:
            page = r.read().decode()
        assert "setParam" in page and "reset system" in page
    finally:
        v.close()
