"""Interactive progressive viewer — the equivalent of the reference's
two interactive harnesses:

- the GLUT app shell (main.cpp:740-1111): spherical-orbit camera driven by
  mouse drag/wheel (main.cpp:811-895 — ``alpha``/``beta`` in degrees,
  ``eye = (r sinA cosB, r sinB, r cosA cosB)``, beta clamped to +-85, r
  floored at 0.1), keys ``p`` (toggle progressive, main.cpp:784-787),
  ``r`` (reset camera, 789-796), ``c`` (print camera, 798-801), and the
  progressive running-mean accumulation (main.cpp:536-599);
- the Shadertoy-style browser harness (P3D_RT.html): a web page with a
  render surface, per-frame progressive refinement, and an FPS meter.

Implementation: a stdlib ``http.server`` holds a :class:`Renderer`; the
browser page posts camera state and pulls PNG frames.  Each ``/frame``
request advances the progressive accumulator by one jittered
sample-per-pixel (Zone A) or renders a full batch frame (Zone B), on
whatever backend jax selected.  Camera
moves reset the accumulator, exactly like ``FrameCount = 1`` in the
reference.

Usage::

    python -m distributionraytracer view P3D_Scenes/balls_low.p3f \
        [--port 8765] [--res 512 512] [--spp 1]

then open http://localhost:8765/.
"""

from __future__ import annotations

import dataclasses
import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>distributionraytracer</title>
<style>
 body { background: #111; color: #ddd; font-family: monospace; margin: 0; }
 #bar { padding: 6px 10px; }
 #bar span { margin-right: 16px; }
 #view { display: block; margin: 0 auto; image-rendering: pixelated;
         cursor: grab; }
 kbd { background: #333; padding: 1px 5px; border-radius: 3px; }
</style></head><body>
<div id="bar">
 <span id="fps">-- fps</span><span id="spp">0 spp</span>
 <span id="cam"></span>
 <span><kbd>drag</kbd> orbit <kbd>wheel</kbd>/<kbd>right-drag</kbd> zoom
 <kbd>p</kbd> progressive <kbd>r</kbd> reset/restart <kbd>c</kbd> print
 camera <kbd>space</kbd> pause <kbd>v</kbd> record webm</span>
</div>
<img id="view" width="__W__" height="__H__">
<canvas id="rec" width="__W__" height="__H__" style="display:none"></canvas>
<script>
let st = null;
let tracking = 0, sx = 0, sy = 0, a0 = 0, b0 = 0, r0 = 0;
let frames = 0, t0 = performance.now(), busy = false;
let paused = false;            // pause/restart UI (P3D_RT.html:2301-2342)
let recorder = null, chunks = [];
const view = document.getElementById('view');
const rec = document.getElementById('rec');

function toggleRecord() {      // webm capture (P3D_RT.html:2342)
  if (recorder) {
    recorder.stop();
    return;
  }
  chunks = [];
  recorder = new MediaRecorder(rec.captureStream(30),
                               { mimeType: 'video/webm' });
  recorder.ondataavailable = e => { if (e.data.size) chunks.push(e.data); };
  recorder.onstop = () => {
    const url = URL.createObjectURL(new Blob(chunks,
                                             { type: 'video/webm' }));
    const a = document.createElement('a');
    a.href = url; a.download = 'capture.webm'; a.click();
    URL.revokeObjectURL(url);
    recorder = null;
    document.getElementById('fps').style.color = '';
  };
  recorder.start();
  document.getElementById('fps').style.color = '#f55';
}

async function init() {
  st = await (await fetch('/state')).json();
  loop();
}
function camParams() {
  return `alpha=${st.alpha}&beta=${st.beta}&r=${st.r}` +
         `&progressive=${st.progressive ? 1 : 0}`;
}
async function loop() {
  if (!busy && !paused) {
    busy = true;
    try {
      const resp = await fetch('/frame?' + camParams());
      st.spp = parseFloat(resp.headers.get('X-Samples') || '0');
      const blob = await resp.blob();
      const url = URL.createObjectURL(blob);
      view.onload = () => {
        rec.getContext('2d').drawImage(view, 0, 0);  // feed the recorder
        URL.revokeObjectURL(url);
      };
      view.src = url;
      frames++;
      const now = performance.now();
      if (now - t0 > 1000) {
        document.getElementById('fps').textContent =
          (frames * 1000 / (now - t0)).toFixed(1) + ' fps';
        frames = 0; t0 = now;
      }
      document.getElementById('spp').textContent =
        st.spp.toFixed(0) + ' spp' + (st.progressive ? ' (prog)' : '');
      document.getElementById('cam').textContent =
        `r=${st.r.toFixed(2)} a=${st.alpha.toFixed(1)} b=${st.beta.toFixed(1)}`;
    } finally { busy = false; }
  }
  requestAnimationFrame(loop);
}
view.addEventListener('mousedown', e => {
  tracking = e.button === 2 ? 2 : 1;
  sx = e.clientX; sy = e.clientY; a0 = st.alpha; b0 = st.beta; r0 = st.r;
  e.preventDefault();
});
window.addEventListener('mousemove', e => {
  if (!tracking) return;
  const dx = -e.clientX + sx, dy = e.clientY - sy;
  if (tracking === 1) {                       // orbit (main.cpp:854-864)
    st.alpha = a0 + dx;
    st.beta = Math.max(-85, Math.min(85, b0 + dy));
  } else {                                    // zoom (main.cpp:866-874)
    st.r = Math.max(0.1, r0 + dy * 0.01);
  }
});
window.addEventListener('mouseup', () => tracking = 0);
view.addEventListener('contextmenu', e => e.preventDefault());
view.addEventListener('wheel', e => {        // mouseWheel (main.cpp:884-895)
  st.r = Math.max(0.1, st.r + (e.deltaY > 0 ? 1 : -1) * 0.1);
  e.preventDefault();
});
window.addEventListener('keydown', async e => {
  if (e.key === ' ') {         // pause: no new samples until resumed
    paused = !paused;
    document.getElementById('spp').style.opacity = paused ? 0.4 : 1;
    e.preventDefault();
  }
  else if (e.key === 'v') toggleRecord();
  else if (e.key === 'p') st.progressive = !st.progressive;
  else if (e.key === 'r') st = await (await fetch('/reset')).json();
  else if (e.key === 's') {
    const r = await (await fetch('/screenshot')).json();
    console.log('saved ' + r.path);
  }
  else if (e.key === 'c')
    console.log(`Camera Spherical (${st.r}, ${st.beta}, ${st.alpha})`);
});
init();
</script></body></html>
"""


class ViewerState:
    """Server-side camera + progressive accumulator (main.cpp globals)."""

    def __init__(self, scene, cfg):
        import jax
        from distributionraytracer.renderer import Renderer

        self.lock = threading.Lock()
        self.scene0 = scene
        self.renderer = Renderer(scene, cfg, verbose=True)
        self.key = jax.random.PRNGKey(0)
        self.frame_i = 0
        eye = np.asarray(scene.cam_eye, np.float64)
        # init() (main.cpp:948-960): spherical coords from the scene camera
        self.r0 = float(np.linalg.norm(eye))
        self.beta0 = math.degrees(math.asin(eye[1] / self.r0))
        self.alpha0 = math.degrees(math.atan(eye[0] / eye[2])) \
            if eye[2] != 0.0 else 90.0
        self.reset()

    def reset(self):
        self.alpha, self.beta, self.r = self.alpha0, self.beta0, self.r0
        self.prog_state = self.renderer.progressive_init()
        self.progressive = True
        self._last_cam = None

    def as_json(self):
        return json.dumps(dict(alpha=self.alpha, beta=self.beta, r=self.r,
                               progressive=self.progressive, spp=0))

    def _eye(self):
        a = math.radians(self.alpha)
        b = math.radians(self.beta)
        return np.array([self.r * math.sin(a) * math.cos(b),
                         self.r * math.sin(b),
                         self.r * math.cos(a) * math.cos(b)], np.float32)

    def frame(self, alpha, beta, r, progressive):
        """Render one frame; returns (rgb u8 HWC, samples_so_far)."""
        import jax
        from distributionraytracer.utils.image import to_u8

        self.alpha, self.beta, self.r = alpha, beta, r
        self.progressive = progressive
        cam = (round(alpha, 4), round(beta, 4), round(r, 4))
        if cam != self._last_cam:  # FrameCount = 1 on camera motion
            self.prog_state = self.renderer.progressive_init()
            self._last_cam = cam
        scene = dataclasses.replace(self.renderer.scene, cam_eye=self._eye())
        self.renderer.scene = scene
        import jax
        self.frame_i += 1
        key = jax.random.fold_in(self.key, self.frame_i)
        if progressive:
            self.prog_state = self.renderer.progressive_step(
                self.prog_state, key)
            mean, count = self.prog_state
            img, n = np.asarray(mean), float(count)
        else:
            img = np.asarray(self.renderer.render(key))
            n = max(self.renderer.cfg.spp, 1)
        self.last_rgb = to_u8(img)  # current accumulator, for /screenshot
        return self.last_rgb, n

    def screenshot(self, path=None):
        """Save the current accumulator as PNG (P3D_RT.html:2301 parity).

        Returns (path, n_samples); raises RuntimeError before any frame."""
        if getattr(self, "last_rgb", None) is None:
            raise RuntimeError("no frame rendered yet")
        if path is None:
            import time as _t
            path = f"viewer_screenshot_{int(_t.time())}.png"
        with open(path, "wb") as f:
            f.write(_png_bytes(self.last_rgb))
        return path, float(self.prog_state[1]) if self.progressive else 1.0


class PTViewerState:
    """Interactive progressive PATH TRACER state — the browser harness's
    real workload (P3D_RT.html:1753-1783): per-frame one-spp refinement
    with ping-pong accumulation, orbit camera from the mouse with the
    per-scene at/zoom defaults of GetCameraVectors (P3D_RT.glsl:687-735),
    accumulator reset while the camera moves.

    Same handler interface as :class:`ViewerState`; accumulates
    (linear-mean, count) exactly like the alpha-channel sample count
    (P3D_RT.glsl:784-792) and displays through gamma 2.2.
    """

    # per-scene orbit defaults (P3D_RT.glsl:689-735): (at, radius)
    SCENE_CAM = {
        0: ((0.0, 0.5, 0.0), 8.86),   # scene 0: length(6,1.6,-6) orbit
        1: ((0.0, -3.0, 10.0), 17.1),
        2: ((0.0, -3.0, 10.0), 17.1),
        3: ((0.0, -3.0, 10.0), 17.1),
        4: ((0.0, -1.0, 10.0), 12.2),
    }

    def __init__(self, scene_id: int, cfg, res=(400, 300), cubemap=None,
                 chunk_spp: int = 1):
        import jax
        from distributionraytracer.scene.generate import pt_scene

        self.lock = threading.Lock()
        self.scene = pt_scene(scene_id, 0, cubemap).device_put()
        self.cfg = cfg
        self.res_x, self.res_y = res
        self.chunk_spp = chunk_spp
        self.scene_id = scene_id
        self.key = jax.random.PRNGKey(0)
        self.frame_i = 0
        at, r = self.SCENE_CAM[scene_id]
        self.at = np.array(at, np.float32)
        self.r0 = r
        self.alpha0, self.beta0 = 45.0, 10.0
        self.reset()

    def reset(self):
        self.alpha, self.beta, self.r = self.alpha0, self.beta0, self.r0
        self.mean = np.zeros((self.res_y, self.res_x, 3), np.float32)
        self.count = 0.0
        self.progressive = True
        self._last_cam = None

    def as_json(self):
        return json.dumps(dict(alpha=self.alpha, beta=self.beta, r=self.r,
                               progressive=self.progressive, spp=0))

    def _eye(self):
        a = math.radians(self.alpha)
        b = math.radians(self.beta)
        return self.at + np.array(
            [self.r * math.sin(a) * math.cos(b),
             self.r * math.sin(b),
             -self.r * math.cos(a) * math.cos(b)], np.float32)

    def frame(self, alpha, beta, r, progressive):
        import jax
        import jax.numpy as jnp
        from distributionraytracer.integrator import pathtracer as PT
        from distributionraytracer.utils.image import to_u8

        self.alpha, self.beta, self.r = alpha, beta, r
        self.progressive = progressive
        cam = (round(alpha, 4), round(beta, 4), round(r, 4))
        if cam != self._last_cam:  # w reset while dragging (glsl:779-783)
            self.mean = np.zeros_like(self.mean)
            self.count = 0.0
            self._last_cam = cam
        self.frame_i += 1
        key = jax.random.fold_in(self.key, self.frame_i)
        img = np.asarray(PT.render_pt(
            self.scene, self.cfg, self.res_x, self.res_y, key=key,
            eye=self._eye(), at=self.at, spp=self.chunk_spp))
        # progressive mix(prev, color, 1/w) in LINEAR space (glsl:784-792)
        n2 = self.count + self.chunk_spp
        self.mean = self.mean + (img - self.mean) * (self.chunk_spp / n2)
        self.count = n2
        self.last_rgb = to_u8(np.asarray(
            np.clip(self.mean, 0.0, None) ** (1.0 / 2.2)))
        return self.last_rgb, self.count

    def screenshot(self, path=None):
        if getattr(self, "last_rgb", None) is None:
            raise RuntimeError("no frame rendered yet")
        if path is None:
            import time as _t
            path = f"viewer_pt_screenshot_{int(_t.time())}.png"
        with open(path, "wb") as f:
            f.write(_png_bytes(self.last_rgb))
        return path, self.count


def _png_bytes(rgb_u8):
    from distributionraytracer.utils.image import encode_png
    # image rows are y-up (viewport convention); flip for display
    return encode_png(rgb_u8[::-1])


def make_server(scene, cfg, port: int = 8765, state=None):
    """Build the HTTP server (separated from serve() for tests).

    ``state``: a prebuilt ViewerState/PTViewerState; default builds the
    Whitted ViewerState for ``scene``."""
    if state is None:
        state = ViewerState(scene, cfg)
        H = scene.static.res_y
        W = scene.static.res_x
    else:
        H, W = state.res_y, state.res_x
    page = _PAGE.replace("__W__", str(W)).replace("__H__", str(H))

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, body, ctype, extra=()):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in extra:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urlparse(self.path)
            if u.path == "/":
                self._send(page.encode(), "text/html")
            elif u.path == "/state":
                self._send(state.as_json().encode(), "application/json")
            elif u.path == "/reset":
                with state.lock:
                    state.reset()
                self._send(state.as_json().encode(), "application/json")
            elif u.path == "/frame":
                q = parse_qs(u.query)
                g = lambda k, d: float(q.get(k, [d])[0])
                with state.lock:
                    rgb, n = state.frame(
                        g("alpha", state.alpha), g("beta", state.beta),
                        g("r", state.r),
                        q.get("progressive", ["1"])[0] == "1")
                self._send(_png_bytes(rgb), "image/png",
                           [("X-Samples", str(n)),
                            ("Cache-Control", "no-store")])
            elif u.path == "/screenshot":
                # save the current accumulator to disk, like the WebGL
                # harness's screenshot button (P3D_RT.html:2301)
                q = parse_qs(u.query)
                path = q.get("path", [None])[0]
                try:
                    with state.lock:
                        p, n = state.screenshot(path)
                    self._send(json.dumps(
                        {"path": p, "samples": n}).encode(),
                        "application/json")
                except RuntimeError as e:
                    self.send_error(409, str(e))
            else:
                self.send_error(404)

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def serve(scene, cfg, port: int = 8765):
    httpd = make_server(scene, cfg, port)
    print(f"viewer on http://localhost:{port}/  "
          f"({scene.static.res_x}x{scene.static.res_y}, "
          f"accel={scene.static.accel})")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass


def serve_pt(scene_id: int, cfg, port: int = 8765, res=(400, 300),
             cubemap=None, chunk_spp: int = 1):
    """Interactive progressive path tracer (component 24's real harness:
    P3D_RT.html drives the MC path tracer, not the Whitted renderer)."""
    state = PTViewerState(scene_id, cfg, res=res, cubemap=cubemap,
                          chunk_spp=chunk_spp)
    httpd = make_server(None, cfg, port, state=state)
    print(f"path-tracer viewer on http://localhost:{port}/  "
          f"(GLSL scene {scene_id}, {res[0]}x{res[1]}, "
          f"{chunk_spp} spp/frame)")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
