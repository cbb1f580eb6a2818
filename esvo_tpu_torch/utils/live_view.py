"""Live map/trajectory viewer — the rviz/rqt analogue, in a browser (a
copy of esvo_tpu/utils/live_view.py: numpy and the standard library only).

The reference watches the system through rviz + rqt image views wired to
the debug image topics (launch/system/system_rpg.launch:60-63,
esvo_Mapping.cpp:143-146). This module serves the same live panels over
plain HTTP so any browser becomes the viewer (PNG encoding is ~20 lines
of zlib).

Usage (wired into scripts/torch_run_dataset.py and
scripts/torch_run_live.py via --live-view PORT):

    viewer = LiveViewer(port=8090)
    viewer.update("inv_depth", rgb_uint8_array)   # any (H, W, 3) uint8
    viewer.update_text("status", "WORKING  tick 512  map 3841")
    ...
    viewer.close()

Endpoints: `/` auto-refreshing dashboard; `/frame/<name>.png` latest
frame; `/state.json` panel list + text lines; POST `/param` with a
`section.field=value` body and POST `/reset` — the dynamic_reconfigure
analogue (reference GUI spec esvo_core/cfg/DVS_MappingStereo.cfg, whose
change handler triggers a system reset, esvo_Mapping.cpp:806-866).
Callers wire `on_param`/`on_reset` to `EsvoSystem.reconfigure()`/
`reset()` (scripts/torch_run_dataset.py does).
"""
from __future__ import annotations

import json
import struct
import threading
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def encode_png(rgb: np.ndarray) -> bytes:
    """Minimal RGB8 PNG encoder (no filtering beyond per-row None)."""
    a = np.ascontiguousarray(rgb, dtype=np.uint8)
    if a.ndim == 2:
        a = np.repeat(a[:, :, None], 3, axis=2)
    h, w, c = a.shape
    assert c == 3, "encode_png wants (H, W, 3) uint8"
    raw = b"".join(b"\x00" + a[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


_PAGE = """<!doctype html><html><head><title>esvo_tpu live</title>
<style>
 body {{ background:#111; color:#ddd; font-family:monospace; margin:12px }}
 .panel {{ display:inline-block; margin:6px; vertical-align:top }}
 .panel img {{ image-rendering:pixelated; border:1px solid #333;
              width:{scale}%; height:auto; max-width:640px }}
 .panel div {{ text-align:center; padding:2px; color:#8bc }}
 #text {{ white-space:pre; color:#9d9; margin:8px 0 }}
</style></head><body>
<h3>esvo_tpu live view</h3><div id="text"></div>
<div id="ctl" style="margin:8px 0">
 <input id="param" size="42" placeholder="section.field=value">
 <button onclick="setParam()">set</button>
 <button onclick="doReset()">reset system</button>
 <span id="ctlmsg" style="color:#c96;margin-left:8px"></span>
</div>
<div id="panels"></div>
<script>
async function setParam() {{
  const v = document.getElementById('param').value;
  const r = await fetch('param', {{method:'POST', body:v}});
  document.getElementById('ctlmsg').textContent = await r.text();
}}
async function doReset() {{
  const r = await fetch('reset', {{method:'POST'}});
  document.getElementById('ctlmsg').textContent = await r.text();
}}
async function tick() {{
  try {{
    const s = await (await fetch('state.json')).json();
    document.getElementById('text').textContent =
        Object.entries(s.text).map(([k,v]) => k + ': ' + v).join('\\n');
    const host = document.getElementById('panels');
    for (const name of s.frames) {{
      let el = document.getElementById('p_' + name);
      if (!el) {{
        el = document.createElement('div');
        el.className = 'panel'; el.id = 'p_' + name;
        el.innerHTML = '<img id="i_' + name + '"><div>' + name + '</div>';
        host.appendChild(el);
      }}
      document.getElementById('i_' + name).src =
          'frame/' + name + '.png?t=' + Date.now();
    }}
  }} catch (e) {{}}
  setTimeout(tick, {period_ms});
}}
tick();
</script></body></html>"""


class LiveViewer:
    """Threaded HTTP dashboard of the latest frames/text (newest wins;
    no history — this is a monitor, not a recorder)."""

    def __init__(self, port: int = 8090, host: str = "0.0.0.0",
                 period_ms: int = 250, scale_pct: int = 100,
                 on_param=None, on_reset=None):
        """on_param: callable(str `section.field=value`) -> status text
        (raise ValueError to reject); on_reset: callable() -> None.
        Both run on the HTTP thread — wire them to callables that queue
        or lock appropriately (torch_run_dataset applies them between
        chunks)."""
        self._frames: dict[str, bytes] = {}
        self._text: dict[str, str] = {}
        self._order: list[str] = []
        self._lock = threading.Lock()
        self._on_param = on_param
        self._on_reset = on_reset
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence request spam
                pass

            def do_GET(self):
                path = self.path.split("?")[0]
                if path in ("/", "/index.html"):
                    body = _PAGE.format(period_ms=period_ms,
                                        scale=scale_pct).encode()
                    self._reply(200, "text/html", body)
                elif path == "/state.json":
                    with viewer._lock:
                        body = json.dumps(
                            {"frames": list(viewer._order),
                             "text": dict(viewer._text)}).encode()
                    self._reply(200, "application/json", body)
                elif path.startswith("/frame/") and path.endswith(".png"):
                    name = path[len("/frame/"):-len(".png")]
                    with viewer._lock:
                        png = viewer._frames.get(name)
                    if png is None:
                        self._reply(404, "text/plain", b"no such frame")
                    else:
                        self._reply(200, "image/png", png)
                else:
                    self._reply(404, "text/plain", b"not found")

            def do_POST(self):
                path = self.path.split("?")[0]
                n = int(self.headers.get("Content-Length", 0) or 0)
                body = self.rfile.read(n).decode("utf-8",
                                                 "replace").strip()
                if path == "/param":
                    if viewer._on_param is None:
                        self._reply(501, "text/plain",
                                    b"no parameter handler wired")
                        return
                    try:
                        msg = viewer._on_param(body) or "ok"
                        self._reply(200, "text/plain", str(msg).encode())
                    except Exception as e:  # reject with the reason
                        self._reply(400, "text/plain",
                                    f"{type(e).__name__}: {e}".encode())
                elif path == "/reset":
                    if viewer._on_reset is None:
                        self._reply(501, "text/plain",
                                    b"no reset handler wired")
                        return
                    try:
                        viewer._on_reset()
                        self._reply(200, "text/plain", b"reset queued")
                    except Exception as e:
                        self._reply(400, "text/plain",
                                    f"{type(e).__name__}: {e}".encode())
                else:
                    self._reply(404, "text/plain", b"not found")

            def _reply(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]   # resolved if port=0
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def update(self, name: str, rgb: np.ndarray) -> None:
        png = encode_png(np.asarray(rgb))
        with self._lock:
            if name not in self._frames:
                self._order.append(name)
            self._frames[name] = png

    def update_text(self, key: str, value: str) -> None:
        with self._lock:
            self._text[key] = str(value)

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=2.0)
