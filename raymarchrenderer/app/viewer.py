"""Interactive viewer: the GUI frontend, served over HTTP.

The reference's GUI (`GUI.cpp:181-321`) is an SFGUI desktop panel over the
live accumulation texture: a Render button, samples / image W/H / grid W/H
entries, a scene path + Load button, right-drag image pan and mouse-wheel
zoom (`GUI.cpp:328-364`), with the progressive render redrawn every frame
(`GUI.cpp:366-375` → `Graphics::Display`).

A desktop toolkit is the wrong shape for an accelerator host (the cards
are usually on the far side of a network), so the equivalent here is a dependency-free
HTTP viewer: a background render thread drives the progressive loop and a
stdlib `http.server` serves

  * ``/``              — the control panel + canvas page (pan: drag,
                         zoom: wheel — client-side, like the reference's
                         quad-geometry pan/zoom `Graphics.cpp:227-258`),
  * ``/api/state``     — render progress JSON (poll-driven redraw),
  * ``/api/image.png`` — the current accumulation, sRGB-encoded,
  * ``/api/render``    — POST: (re)start with scene/spp/size/grid,
  * ``/api/stop``      — POST: cancel, keeping the partial image
                         (Escape semantics, `Program.cpp:188-194`),
  * ``/api/scenes``    — builtin + data/scenes listing (the reference's
                         tinydir directory scan, `GUI.cpp:7-34`).

Run: ``python -m raymarchrenderer.app viewer --port 8000``.
"""
from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>raymarch viewer</title><style>
body { font-family: system-ui, sans-serif; margin: 0; display: flex;
       height: 100vh; background: #16161d; color: #ddd; }
#panel { width: 240px; padding: 12px; background: #1f1f28; }
#panel label { display: block; margin: 8px 0 2px; font-size: 12px;
               color: #aab; }
#panel input, #panel select { width: 100%; box-sizing: border-box;
  background: #2a2a35; color: #eee; border: 1px solid #444; padding: 4px; }
#panel button { margin-top: 12px; width: 100%; padding: 8px;
  background: #4a6; color: #fff; border: 0; cursor: pointer; }
#panel button.stop { background: #a55; }
#status { margin-top: 10px; font-size: 12px; color: #8c8; }
#view { flex: 1; overflow: hidden; position: relative; cursor: grab; }
canvas { position: absolute; image-rendering: pixelated; }
</style></head><body>
<div id="panel">
  <b>raymarch renderer</b>
  <label>scene</label><select id="scene"></select>
  <label>samples</label><input id="spp" type="number" value="64">
  <label>image width</label><input id="w" type="number" value="512">
  <label>image height</label><input id="h" type="number" value="512">
  <label>grid w×h</label><input id="grid" value="4x4">
  <label>max bounces</label><input id="bounces" type="number" value="8">
  <label>env map (.hdr path, optional)</label><input id="env" value="">
  <label><input id="spectral" type="checkbox" style="width:auto">
    spectral (gen-3 wavelength transport)</label>
  <label><input id="nee" type="checkbox" style="width:auto">
    direct light (NEE soft shadows)</label>
  <button id="render">Render</button>
  <button id="stop" class="stop">Stop</button>
  <button id="camreset">Reset camera</button>
  <div id="status">idle</div>
  <div style="margin-top:10px;font-size:11px;color:#889">
    drag: pan canvas · wheel: zoom canvas<br>
    shift-drag: orbit · ctrl-drag: pan camera · ctrl-wheel: dolly</div>
</div>
<div id="view"><canvas id="cv"></canvas></div>
<script>
const cv = document.getElementById('cv'), view = document.getElementById('view');
let zoom = 1, ox = 20, oy = 20, drag = null, lastN = -1;
function place() { cv.style.transform = `scale(${zoom})`;
  cv.style.transformOrigin = '0 0';
  cv.style.left = ox + 'px'; cv.style.top = oy + 'px'; }
let camdrag = null;
const camOp = o => fetch('api/camera',
  { method: 'POST', body: JSON.stringify(o) }).then(() => lastN = -1);
view.onmousedown = e => {
  if (e.shiftKey || e.ctrlKey) { camdrag = [e.clientX, e.clientY, e.ctrlKey]; }
  else { drag = [e.clientX - ox, e.clientY - oy]; } };
window.onmousemove = e => { if (drag) { ox = e.clientX - drag[0];
  oy = e.clientY - drag[1]; place(); } };
window.onmouseup = e => {
  if (camdrag) {  // one op per gesture: each op restarts the accumulation
    const dx = e.clientX - camdrag[0], dy = e.clientY - camdrag[1];
    if (camdrag[2]) camOp({ op: 'pan', dx: -dx * 0.01, dy: dy * 0.01 });
    else camOp({ op: 'orbit', ax: -dx * 0.005, ay: -dy * 0.005 });
    camdrag = null; }
  drag = null; };
view.onwheel = e => { e.preventDefault();
  if (e.ctrlKey) { camOp({ op: 'zoom', amount: -Math.sign(e.deltaY) * 0.5 }); }
  else { zoom *= Math.pow(1.1, -Math.sign(e.deltaY)); place(); } };
document.getElementById('camreset').onclick = () => camOp({ op: 'reset' });
async function refresh() {
  const st = await (await fetch('api/state')).json();
  document.getElementById('status').textContent =
    (st.rendering ? 'rendering ' : 'idle ') + st.n.toFixed(0) + '/' + st.spp
    + ' spp' + (st.error ? ' — ' + st.error : '');
  if (st.n !== lastN && st.n > 0) {
    lastN = st.n;
    const img = new Image();
    img.onload = () => { cv.width = img.width; cv.height = img.height;
      cv.getContext('2d').drawImage(img, 0, 0); place(); };
    img.src = 'api/image.png?n=' + st.n;
  }
}
setInterval(refresh, 700);
(async () => {
  const sc = await (await fetch('api/scenes')).json();
  const sel = document.getElementById('scene');
  for (const s of sc) { const o = document.createElement('option');
    o.textContent = s; sel.appendChild(o); } })();
document.getElementById('render').onclick = async () => {
  lastN = -1;
  const g = document.getElementById('grid').value.split('x');
  await fetch('api/render', { method: 'POST', body: JSON.stringify({
    scene: document.getElementById('scene').value,
    spp: +document.getElementById('spp').value,
    width: +document.getElementById('w').value,
    height: +document.getElementById('h').value,
    grid_width: +g[0] || 4, grid_height: +g[1] || 4,
    max_bounces: +document.getElementById('bounces').value,
    env_map: document.getElementById('env').value || null,
    spectral: document.getElementById('spectral').checked,
    direct_light: document.getElementById('nee').checked })});
};
document.getElementById('stop').onclick = () =>
  fetch('api/stop', { method: 'POST' });
</script></body></html>"""


class ViewerState:
    """Shared progressive-render state driven by a worker thread."""

    def __init__(self, scene_dirs=("data/scenes",)):
        self.lock = threading.Lock()
        self.accum = None          # (H, W, 3) float32 linear (numpy)
        self.n = 0.0
        self.spp = 0
        self.rendering = False
        self.error = ""
        self.scene_dirs = scene_dirs
        self.camera = None         # persistent interactive pose
        self._last_req = {}        # re-rendered on camera ops
        self._ever_started = False  # camera ops before the first render
        #                             only pose — they must not launch one
        self._cancel = threading.Event()
        self._thread = None

    # -- scene listing (GUI.cpp:7-34 directory scan) -------------------------
    def scenes(self):
        from raymarchrenderer.app.cli import _build_scene  # noqa: F401
        names = ["sphere_on_floor", "single_sphere", "csg", "cornell",
                 "glass", "volume"]
        for d in self.scene_dirs:
            if os.path.isdir(d):
                names += sorted(
                    os.path.join(d, f) for f in os.listdir(d)
                    if f.endswith(".scene"))
        return names

    # -- render control ------------------------------------------------------
    def start(self, req: dict):
        self.stop()
        self._last_req = dict(req)
        self._ever_started = True
        self._cancel.clear()
        with self.lock:
            # mark the restart SYNCHRONOUSLY: the worker thread takes a
            # while to import jax and reset the buffer, and a client that
            # polls /api/state in that window must not see the previous
            # render's finished (n, rendering=False) as if it were this one
            self.rendering = True
            self.n = 0.0
        self._thread = threading.Thread(
            target=self._run, args=(req,), daemon=True)
        self._thread.start()

    # -- interactive camera (Camera.cpp:104-137: the reference wired
    # zoom/pan/orbit ops; its input handling was commented out — here they
    # are a product surface: each op mutates the persistent pose and
    # restarts the progressive accumulation at 0 spp) --------------------
    def camera_op(self, op: dict) -> dict:
        from raymarchrenderer.core.camera import Camera
        with self.lock:
            if self.camera is None:
                self.camera = Camera()
            cam = self.camera
            kind = op.get("op", "")
            if kind == "orbit":
                cam.orbit(float(op.get("ax", 0.0)), float(op.get("ay", 0.0)))
            elif kind == "pan":
                cam.pan(float(op.get("dx", 0.0)), float(op.get("dy", 0.0)))
            elif kind == "zoom":
                cam.zoom(float(op.get("amount", 0.0)))
            elif kind == "reset":
                self.camera = cam = Camera(aspect=cam.aspect)
            elif kind == "look_at":
                cam.look_at(tuple(op.get("target", (0.0, 0.0, 0.0))))
            else:
                raise ValueError(f"unknown camera op: {kind!r}")
            pose = {"eye": list(cam.eye), "direction": list(cam.direction)}
            req = dict(self._last_req) if self._ever_started else None
        if req is not None:
            # restart the progressive buffer under the new pose
            self.start(req)
        # before any render: just move the pose — do NOT launch an
        # unrequested render of the default scene
        return pose

    def stop(self):
        self._cancel.set()
        t = self._thread
        if t is not None:
            t.join(timeout=60)
        with self.lock:
            self.rendering = False

    def _run(self, req: dict):
        try:
            import jax.numpy as jnp

            from raymarchrenderer.app.cli import _build_scene
            from raymarchrenderer.core.camera import Camera
            from raymarchrenderer.render.config import RenderConfig
            from raymarchrenderer.render.integrator import (
                _sample_step)

            class _A:
                scene = req.get("scene", "sphere_on_floor")
                env_map = req.get("env_map")

            scene = _build_scene(_A)
            params = scene.init_params()
            cfg = RenderConfig(
                width=int(req.get("width", 512)),
                height=int(req.get("height", 512)),
                spp=int(req.get("spp", 64)),
                max_steps=int(req.get("max_steps", 256)),
                max_bounces=int(req.get("max_bounces", 8)),
                max_dist=float(req.get("max_dist", 1000.0)),
                grid_width=int(req.get("grid_width", 4)),
                grid_height=int(req.get("grid_height", 4)))
            with self.lock:
                if self.camera is None:
                    self.camera = Camera(aspect=cfg.width / cfg.height)
                else:
                    self.camera.aspect = cfg.width / cfg.height
                corners = self.camera.corner_rays_flat()
            with self.lock:
                self.accum = np.zeros((cfg.height, cfg.width, 3),
                                      np.float32)
                self.n = 0.0
                self.spp = cfg.spp
                self.rendering = True
                self.error = ""
            spectral = bool(req.get("spectral"))
            direct_light = bool(req.get("direct_light"))
            # fused Pallas path on the GPU (pads-and-crops any frame size),
            # oracle on the CPU — the one route chooser
            from raymarchrenderer.kernels.route import TRITON, kernel_route
            use_fused = kernel_route() == TRITON
            if spectral:
                from raymarchrenderer.render.spectral_integrator import (
                    _spectral_step, band_table)
                mats = band_table(scene)
                if use_fused:
                    from raymarchrenderer.kernels.march import (
                        render_progressive_fused_spectral)

                    def _cb(s, state):
                        with self.lock:
                            self.accum = np.asarray(state[0])
                            self.n = float(state[1])
                        if self._cancel.is_set():
                            raise KeyboardInterrupt  # cooperative cancel

                    try:
                        render_progressive_fused_spectral(
                            scene, params, mats, cfg, corners, spp=cfg.spp,
                            samples_per_launch=4, callback=_cb)
                    except KeyboardInterrupt:
                        pass
                    return
                state = (jnp.zeros((cfg.height, cfg.width, 3), jnp.float32),
                         jnp.float32(0.0))
                for s in range(cfg.spp):
                    if self._cancel.is_set():
                        break
                    state = _spectral_step(scene, params, mats, cfg,
                                           corners, state, jnp.uint32(s))
                    with self.lock:
                        self.accum = np.asarray(state[0])
                        self.n = float(state[1])
                return
            if use_fused:
                # megakernel for every RGB workload — NEE shadow marches
                # run as in-loop segments and env-map scenes defer their
                # sky to the composite
                from raymarchrenderer.kernels.march import (
                    render_progressive_fused)
                img, n = None, 0.0
                chunk = 4
                while n < cfg.spp and not self._cancel.is_set():
                    k = min(chunk, cfg.spp - int(n))
                    img, n = render_progressive_fused(
                        scene, params, cfg, corners, spp=k,
                        samples_per_launch=k, accum=img, n0=n,
                        direct_light=direct_light)
                    with self.lock:
                        self.accum = np.asarray(img)
                        self.n = float(n)
                return
            state = (jnp.zeros((cfg.height, cfg.width, 3), jnp.float32),
                     jnp.float32(0.0))
            for s in range(cfg.spp):
                if self._cancel.is_set():
                    break
                state = _sample_step(scene, params, cfg, corners, state,
                                     jnp.uint32(s), direct_light)
                with self.lock:
                    self.accum = np.asarray(state[0])
                    self.n = float(state[1])
        except Exception as e:  # surface into the status line
            with self.lock:
                self.error = f"{type(e).__name__}: {e}"
        finally:
            with self.lock:
                self.rendering = False

    # -- encoded outputs -----------------------------------------------------
    def png_bytes(self) -> bytes:
        from raymarchrenderer.io.image import png_bytes
        with self.lock:
            img = None if self.accum is None else self.accum.copy()
        if img is None:
            img = np.zeros((16, 16, 3), np.float32)
        return png_bytes(img)  # in-memory encode — no temp file per poll

    def state_json(self) -> bytes:
        with self.lock:
            cam = self.camera
            return json.dumps({
                "rendering": self.rendering, "n": self.n, "spp": self.spp,
                "width": 0 if self.accum is None else self.accum.shape[1],
                "height": 0 if self.accum is None else self.accum.shape[0],
                "camera": None if cam is None else {
                    "eye": list(cam.eye),
                    "direction": list(cam.direction)},
                "error": self.error}).encode()


def make_server(port: int = 8000, host: str = "127.0.0.1",
                state: ViewerState = None) -> ThreadingHTTPServer:
    st = state or ViewerState()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, body: bytes, ctype: str, code: int = 200):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/":
                self._send(_PAGE.encode(), "text/html")
            elif path == "/api/state":
                self._send(st.state_json(), "application/json")
            elif path == "/api/image.png":
                self._send(st.png_bytes(), "image/png")
            elif path == "/api/scenes":
                self._send(json.dumps(st.scenes()).encode(),
                           "application/json")
            else:
                self._send(b"not found", "text/plain", 404)

        def do_POST(self):
            path = self.path.split("?")[0]
            n = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(n) if n else b"{}"
            if path == "/api/render":
                try:
                    st.start(json.loads(body or b"{}"))
                    self._send(b'{"ok": true}', "application/json")
                except Exception as e:
                    self._send(json.dumps(
                        {"ok": False, "error": str(e)}).encode(),
                        "application/json", 400)
            elif path == "/api/camera":
                try:
                    pose = st.camera_op(json.loads(body or b"{}"))
                    self._send(json.dumps(
                        {"ok": True, **pose}).encode(), "application/json")
                except Exception as e:
                    self._send(json.dumps(
                        {"ok": False, "error": str(e)}).encode(),
                        "application/json", 400)
            elif path == "/api/stop":
                st.stop()
                self._send(b'{"ok": true}', "application/json")
            else:
                self._send(b"not found", "text/plain", 404)

    srv = ThreadingHTTPServer((host, port), Handler)
    srv.viewer_state = st
    return srv


def serve(port: int = 8000, host: str = "127.0.0.1") -> None:
    from raymarchrenderer.utils.cache import enable_persistent_cache
    enable_persistent_cache()  # no-op if RAYMARCH_NO_CACHE=1
    srv = make_server(port, host)
    print(f"viewer at http://{host}:{srv.server_address[1]}/")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.viewer_state.stop()
        srv.server_close()
