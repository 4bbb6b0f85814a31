"""Live-training web GUI (port of threedgrut_tpu/playground/live_gui.py;
reference: threedgrut/utils/gui.py:34 polyscope GUI,
threedgrut/utils/viser_gui_util.py viser GUI), on ``http.server``:

- live training view: watch the model render while training runs, with
  step / loss / PSNR / particle-count HUD,
- train / pause toggle (gui.py train-pause checkbox),
- orbit camera from the browser (``web_gui.orbit_camera``) driving the
  port's ``render_gut`` on the trainer's model,
- render modes: rgb, depth, opacity and hit-count jet maps
  (``utils/misc.py:jet_map``), and a point-cloud overlay of Gaussian
  centers (gui.py point-cloud view),
- trajectory fly-through: record orbit keyframes in the browser, preview
  them, and export an interpolated video (``video.write_video``).

Device work (train steps and renders) stays on the caller's thread: HTTP
handlers only enqueue requests and read cached frames. Use
:meth:`TrainingGUI.run` as the training loop; it calls
``Trainer.train_iteration`` once a step (the JAX loop's dispatch groups
have no counterpart in the port). The rgb mode shows the trainer's
decoded colour (``Trainer.decode``), which for SH features is
``pred_features`` as in JAX, and for NHT the decoder's output.
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from .web_gui import orbit_camera

_PAGE = """<!DOCTYPE html>
<html><head><title>threedgrut_tpu_torch live</title>
<style>
body{margin:0;background:#14151a;color:#e8e8ee;font-family:system-ui,sans-serif}
#wrap{display:flex}#side{width:260px;padding:12px;font-size:13px}
#v{display:block;background:#000}
button{margin:2px;padding:4px 10px;background:#2a2d3a;color:#e8e8ee;
border:1px solid #444;border-radius:4px;cursor:pointer}
button:hover{background:#3a3f52}
.stat{display:flex;justify-content:space-between;margin:2px 0}
.stat span:last-child{color:#9fe8a9;font-variant-numeric:tabular-nums}
select{background:#2a2d3a;color:#e8e8ee;border:1px solid #444}
h3{margin:10px 0 4px;font-size:13px;color:#aab}
</style></head><body>
<div id="wrap">
<img id="v" width="__W__" height="__H__">
<div id="side">
  <h3>Training</h3>
  <div class="stat"><span>step</span><span id="step">-</span></div>
  <div class="stat"><span>loss</span><span id="loss">-</span></div>
  <div class="stat"><span>psnr</span><span id="psnr">-</span></div>
  <div class="stat"><span>gaussians</span><span id="ng">-</span></div>
  <div class="stat"><span>it/s</span><span id="ips">-</span></div>
  <button id="pause">pause</button>
  <h3>View</h3>
  <select id="mode">
    <option value="rgb">rgb</option><option value="depth">depth</option>
    <option value="opacity">opacity</option><option value="hits">hits</option>
    <option value="points">points</option>
  </select>
  <div style="margin-top:4px;color:#889">drag orbit &middot; wheel dolly
  &middot; r reset</div>
  <h3>Fly-through</h3>
  <button id="addkey">add key</button>
  <button id="clearkeys">clear</button>
  <div class="stat"><span>keys</span><span id="nkeys">0</span></div>
  <button id="export">export video</button>
  <div id="vid"></div>
</div></div>
<script>
let az=0, el=0, dist=5, busy=false, paused=false;
const img=document.getElementById('v');
const mode=document.getElementById('mode');
async function refresh(){
  if(busy) return; busy=true;
  img.src=`/frame.jpg?az=${az}&el=${el}&dist=${dist}&mode=${mode.value}`
    +`&t=${Date.now()}`;
  await img.decode().catch(()=>{}); busy=false;
}
async function poll(){
  try{
    const s=await (await fetch('/state')).json();
    for(const k of ['step','loss','psnr','ng','ips','nkeys'])
      document.getElementById(k).textContent=s[k];
    document.getElementById('pause').textContent=s.paused?'resume':'pause';
    if(s.video) document.getElementById('vid').innerHTML=
      `<a href="${s.video}" style="color:#9fe8a9">download video</a>`;
  }catch(e){}
}
let dragging=false, lx=0, ly=0;
img.onmousedown=e=>{dragging=true;lx=e.clientX;ly=e.clientY};
window.onmouseup=()=>dragging=false;
window.onmousemove=e=>{if(!dragging)return;
  az+=(e.clientX-lx)*0.01; el+=(e.clientY-ly)*0.01;
  el=Math.max(-1.5,Math.min(1.5,el)); lx=e.clientX; ly=e.clientY; refresh();};
window.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001); refresh();};
window.onkeydown=e=>{if(e.key=='r'){az=0;el=0;dist=5;refresh();}};
document.getElementById('pause').onclick=()=>fetch('/cmd?op=toggle_pause');
document.getElementById('addkey').onclick=()=>
  fetch(`/cmd?op=addkey&az=${az}&el=${el}&dist=${dist}`);
document.getElementById('clearkeys').onclick=()=>fetch('/cmd?op=clearkeys');
document.getElementById('export').onclick=()=>fetch('/cmd?op=export');
mode.onchange=refresh;
setInterval(refresh, 700); setInterval(poll, 500); refresh(); poll();
</script></body></html>"""


class TrainingGUI:
    """Attach a live web GUI to a Trainer and drive the training loop.

    Usage::

        gui = TrainingGUI(trainer, center=(0, 0, 4), out_dir="runs/x")
        gui.start()           # http server up, prints URL
        gui.run(max_steps=n)  # training loop with live rendering

    ``out_dir`` receives the fly-through video (the port's Trainer has
    no output directory of its own); ``port`` 0 binds a port the system
    picks, which ``start`` reports.
    """

    def __init__(self, trainer, center=(0.0, 0.0, 4.0),
                 resolution=(512, 512), port: int = 8091, *, out_dir: str,
                 host: str = "0.0.0.0"):
        self.trainer = trainer
        self.center = center
        self.resolution = resolution
        self.port = port
        self.host = host
        self.out_dir = out_dir
        self.paused = False
        self.stopped = False
        self._lock = threading.Lock()
        self._pending: Optional[dict] = None   # latest camera request
        self._frames: dict = {}                # "latest" -> jpeg bytes
        self._metrics = {"step": 0, "loss": float("nan"),
                         "psnr": float("nan"), "ng": 0, "ips": 0.0}
        self._keyframes: list = []
        self._export_requested = False
        self._video_path: Optional[str] = None
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        #: seconds an HTTP frame request waits for the device thread
        self.frame_timeout = 180.0
        #: interpolated frames per fly-through keyframe
        self.export_frames_per_key = 12

    # --- rendering ------------------------------------------------------

    @torch.no_grad()
    def _render(self, az, el, dist, mode) -> np.ndarray:
        from ..render.gut import render_gut
        from ..utils.misc import jet_map

        tr = self.trainer
        cam = orbit_camera(az, el, dist, center=self.center,
                           resolution=self.resolution, device=tr.device)
        if mode == "points":
            return self._render_points(cam)
        out = render_gut(cam, tr.conf.ut, tr.conf.raster, tr.model,
                         tr.sh_degree())
        if mode == "depth":
            img = jet_map(out["pred_dist"], 20.0)
        elif mode == "opacity":
            img = jet_map(out["pred_opacity"], 1.0)
        elif mode == "hits":
            img = jet_map(out["hits_count"], 128.0)
        else:
            img = torch.clamp(tr.decode(out), 0.0, 1.0)
        return (img.cpu().numpy() * 255).astype(np.uint8)

    def _render_points(self, cam) -> np.ndarray:
        """Gaussian centers as a point cloud (gui.py point-cloud view)."""
        from ..ops.quaternion import quat_to_rotmat

        tr = self.trainer
        w, h = self.resolution
        n = tr.model.n_active
        pos = tr.model.positions.detach()[:n].cpu().numpy()
        r = quat_to_rotmat(cam.q_start[None]).cpu().numpy()[0]
        t = cam.t_start.cpu().numpy()
        pc = pos @ r.T + t
        valid = pc[:, 2] > 1e-3
        f = cam.focal.cpu().numpy()
        c = cam.principal.cpu().numpy()
        px = (pc[:, 0] / np.maximum(pc[:, 2], 1e-3) * f[0] + c[0])
        py = (pc[:, 1] / np.maximum(pc[:, 2], 1e-3) * f[1] + c[1])
        img = np.zeros((h, w, 3), np.uint8)
        xi = np.round(px).astype(np.int64)
        yi = np.round(py).astype(np.int64)
        ok = valid & (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        # depth-tinted dots
        z = np.clip(pc[:, 2][ok] / 10.0, 0, 1)
        img[yi[ok], xi[ok], 1] = (255 * (1 - 0.6 * z)).astype(np.uint8)
        img[yi[ok], xi[ok], 2] = (120 + 120 * z).astype(np.uint8)
        return img

    def _export_video(self):
        """Render the interpolated keyframe fly-through to a video file."""
        from .video import write_video

        keys = list(self._keyframes)
        if len(keys) < 2:
            return None
        n_frames = max(2, self.export_frames_per_key * len(keys))
        frames = []
        for f in range(n_frames):
            t = f / n_frames * len(keys)
            i0 = int(np.floor(t)) % len(keys)
            i1 = (i0 + 1) % len(keys)
            a = t - np.floor(t)

            def lerp(k):
                return (1 - a) * keys[i0][k] + a * keys[i1][k]

            frames.append(self._render(lerp("az"), lerp("el"),
                                       lerp("dist"), "rgb"))
        os.makedirs(self.out_dir, exist_ok=True)
        return write_video(frames, os.path.join(self.out_dir,
                                                "flythrough.mp4"), fps=24)

    # --- training loop (device thread) ----------------------------------

    def run(self, max_steps: Optional[int] = None):
        """Training loop with interleaved GUI rendering, one
        ``train_iteration`` a step over the frames in the trainer's
        seeded shuffled order; then keeps serving renders and exports
        until ``stop()`` (the reference GUI blocks in its viewer after
        training, gui.py run loop)."""
        tr = self.trainer
        n = max_steps or tr.conf.n_iterations
        order: list = []
        t_last = time.time()
        s_last = tr.global_step
        while not self.stopped and tr.global_step < n:
            if not self.paused:
                if not order:
                    order = list(np.random.default_rng(
                        tr.conf.seed + tr.global_step).permutation(
                            len(tr.dataset)))
                idx = int(order.pop())
                m = tr.train_iteration(tr.dataset[idx], frame_idx=idx)
                now = time.time()
                ips = (tr.global_step - s_last) / max(now - t_last, 1e-6)
                t_last, s_last = now, tr.global_step
                self._metrics = {
                    "step": tr.global_step,
                    "loss": round(float(m["total"]), 4),
                    "psnr": round(float(m["psnr"]), 2),
                    "ng": int(tr.model.n_active),
                    "ips": round(ips, 1),
                }
            else:
                time.sleep(0.02)
            self._service_requests()
        while not self.stopped:
            self._service_requests()
            time.sleep(0.02)

    def _service_requests(self):
        with self._lock:
            req = self._pending
            self._pending = None
            export = self._export_requested
            self._export_requested = False
        if req is not None:
            img = self._render(req["az"], req["el"], req["dist"],
                               req["mode"])
            from PIL import Image

            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="JPEG", quality=90)
            with self._lock:
                self._frames["latest"] = buf.getvalue()
        if export:
            self._video_path = self._export_video()

    # --- http server ----------------------------------------------------

    def start(self, port: Optional[int] = None) -> str:
        """Serve the page on a background thread; returns its URL, with
        the port actually bound (``port`` 0: the system's pick)."""
        gui = self
        if port is not None:
            self.port = port

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urlparse(self.path)
                q = parse_qs(url.query)

                def num(key, default):
                    return float(q.get(key, [default])[0])

                if url.path == "/":
                    page = (_PAGE.replace("__W__", str(gui.resolution[0]))
                            .replace("__H__", str(gui.resolution[1])))
                    return self._send(200, "text/html", page.encode())
                if url.path == "/state":
                    st = dict(gui._metrics)
                    st["paused"] = gui.paused
                    st["nkeys"] = len(gui._keyframes)
                    st["video"] = "/video.mp4" if gui._video_path else None
                    return self._send(200, "application/json",
                                      json.dumps(st).encode())
                if url.path == "/frame.jpg":
                    with gui._lock:
                        gui._pending = {"az": num("az", "0"),
                                        "el": num("el", "0"),
                                        "dist": num("dist", "5"),
                                        "mode": q.get("mode", ["rgb"])[0]}
                    # wait for the device thread to draw it
                    deadline = time.time() + gui.frame_timeout
                    while time.time() < deadline:
                        with gui._lock:
                            data = gui._frames.get("latest")
                            served = gui._pending is None
                        if data is not None and served:
                            break
                        time.sleep(0.02)
                    with gui._lock:
                        data = gui._frames.get("latest")
                    if data is None:
                        return self._send(503, "text/plain", b"warming up")
                    return self._send(200, "image/jpeg", data)
                if url.path == "/video.mp4" and gui._video_path:
                    vp = gui._video_path
                    if os.path.isdir(vp):
                        # write_video wrote PNG frames (no encoder): zip them
                        import zipfile
                        buf = io.BytesIO()
                        with zipfile.ZipFile(buf, "w") as z:
                            for name in sorted(os.listdir(vp)):
                                z.write(os.path.join(vp, name), name)
                        return self._send(200, "application/zip",
                                          buf.getvalue())
                    with open(vp, "rb") as fh:
                        return self._send(200, "video/mp4", fh.read())
                if url.path == "/cmd":
                    op = q.get("op", [""])[0]
                    if op == "toggle_pause":
                        gui.paused = not gui.paused
                    elif op == "addkey":
                        gui._keyframes.append({"az": num("az", "0"),
                                               "el": num("el", "0"),
                                               "dist": num("dist", "5")})
                    elif op == "clearkeys":
                        gui._keyframes.clear()
                    elif op == "export":
                        with gui._lock:
                            gui._export_requested = True
                    elif op == "stop":
                        gui.stopped = True
                    return self._send(200, "text/plain", b"ok")
                self._send(404, "text/plain", b"not found")

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        url = f"http://localhost:{self.port}/"
        print(f"live GUI: {url}")
        return url

    def stop(self):
        """End ``run`` and the server; any thread may call it, more than
        once."""
        self.stopped = True
        with self._lock:
            server, thread = self._server, self._thread
            self._server = self._thread = None
        if server is not None:
            server.shutdown()
            server.server_close()
        if thread is not None:
            thread.join()
