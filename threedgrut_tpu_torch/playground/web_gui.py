"""Dependency-free web viewer for the playground
(port of threedgrut_tpu/playground/web_gui.py).

A background ``http.server`` serves an HTML page with drag and wheel
orbit controls; the page requests JPEG frames that a render callback
draws on demand. ``orbit_camera`` is the port's pinhole orbit
(``ops/cameras.py:orbit_camera``, which has its own copy of the
rotation-to-quaternion helper).
"""

from __future__ import annotations

import io
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..ops.cameras import orbit_camera  # noqa: F401  (re-exported)

_PAGE = """<!DOCTYPE html>
<html><head><title>threedgrut_tpu_torch viewer</title>
<style>body{margin:0;background:#111;color:#eee;font-family:sans-serif}
#v{display:block;margin:auto}#hud{position:fixed;top:8px;left:8px}</style>
</head><body>
<div id="hud">drag = orbit | wheel = dolly | r = reset</div>
<img id="v" width="__W__" height="__H__">
<script>
let az=0, el=0, dist=5, busy=false;
const img=document.getElementById('v');
async function refresh(){
  if(busy) return; busy=true;
  img.src = `/frame.jpg?az=${az}&el=${el}&dist=${dist}&t=${Date.now()}`;
  await img.decode().catch(()=>{}); busy=false;
}
let dragging=false, lx=0, ly=0;
img.onmousedown=e=>{dragging=true;lx=e.clientX;ly=e.clientY};
window.onmouseup=()=>dragging=false;
window.onmousemove=e=>{ if(!dragging) return;
  az+=(e.clientX-lx)*0.01; el+=(e.clientY-ly)*0.01;
  el=Math.max(-1.5,Math.min(1.5,el)); lx=e.clientX; ly=e.clientY; refresh();};
window.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001); refresh();};
window.onkeydown=e=>{if(e.key=='r'){az=0;el=0;dist=5;refresh();}};
refresh(); setInterval(refresh, 500);
</script></body></html>"""


class ViewerServer:
    """Serves an interactive orbit-camera view of a render callback:
    render_fn(azimuth, elevation, distance) -> uint8 RGB [H, W, 3]."""

    def __init__(self, render_fn: Callable[[float, float, float], np.ndarray],
                 resolution=(512, 512), port: int = 8090,
                 host: str = "0.0.0.0"):
        self.render_fn = render_fn
        self.resolution = resolution
        self.port = port
        self.host = host
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self, blocking: bool = False):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, body: bytes, ctype: str):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urlparse(self.path)
                if url.path == "/":
                    w, h = viewer.resolution
                    self._send(_PAGE.replace("__W__", str(w)).replace(
                        "__H__", str(h)).encode(), "text/html")
                    return
                if url.path == "/frame.jpg":
                    from PIL import Image

                    q = parse_qs(url.query)
                    img = viewer.render_fn(float(q.get("az", ["0"])[0]),
                                           float(q.get("el", ["0"])[0]),
                                           float(q.get("dist", ["5"])[0]))
                    buf = io.BytesIO()
                    Image.fromarray(np.asarray(img, np.uint8)).save(
                        buf, format="JPEG", quality=90)
                    self._send(buf.getvalue(), "image/jpeg")
                    return
                self.send_response(404)
                self.end_headers()

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._server.server_address[1]   # port 0: the OS's pick
        if blocking:
            self._server.serve_forever()
        else:
            self._thread = threading.Thread(
                target=self._server.serve_forever, daemon=True)
            self._thread.start()
        return f"http://localhost:{self.port}/"

    def stop(self):
        if self._server:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join()
            self._thread = None
