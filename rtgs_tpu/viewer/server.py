"""Interactive browser viewer — the replacement for the reference's
``ti.GUI`` window (``/root/reference/src/rtgs/__main__.py:154-258``).

A dependency-free ``http.server`` serving a single-page client: the browser
sends the same orbit-camera events the reference's window handled (LMB drag
= pan, RMB drag = move 3D cursor, wheel = zoom, three sliders = global scene
rotation) to ``/event``; the server runs them through the same
:class:`rtgs_tpu.viewer.orbit.OrbitState` machine, renders a frame on the
accelerator, and streams PNG frames from ``/frame`` (encoded by the stdlib
encoder in ``rtgs_tpu.utils.image``).

Progressive sampling note: the reference accumulates identical deterministic
samples (``ray_tracer.py:39-54`` with pixel-center rays), so a single render
per pose is already the converged image; the viewer therefore re-renders
only when the pose changes.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

logger = logging.getLogger(__name__)

_PAGE = """<!DOCTYPE html>
<html><head><title>rtgs-tpu viewer</title><style>
body { margin:0; background:#111; color:#ddd; font-family:monospace; }
#hud { position:fixed; top:8px; left:8px; background:#000a; padding:8px; }
img { display:block; margin:auto; image-rendering:pixelated; }
input[type=range] { width: 140px; }
</style></head><body>
<div id="hud">
  rtgs-tpu viewer — drag: orbit, right-drag: cursor, wheel: zoom<br>
  Rot X <input type="range" id="rx" min="0" max="6.283" step="0.017" value="0">
  Rot Y <input type="range" id="ry" min="0" max="6.283" step="0.017" value="0">
  Rot Z <input type="range" id="rz" min="0" max="6.283" step="0.017" value="0">
  <span id="stat"></span>
</div>
<img id="view" src="/frame?v=0">
<script>
const img = document.getElementById('view');
let v = 0, busy = false, queued = null;
async function send(ev) {
  if (busy) { queued = ev; return; }
  busy = true;
  const t0 = performance.now();
  await fetch('/event', {method:'POST', body: JSON.stringify(ev)});
  img.src = '/frame?v=' + (++v);
  img.onload = () => {
    document.getElementById('stat').textContent =
      ' ' + Math.round(performance.now() - t0) + ' ms';
    busy = false;
    if (queued) { const q = queued; queued = null; send(q); }
  };
}
let drag = null;
img.addEventListener('contextmenu', e => e.preventDefault());
img.addEventListener('mousedown', e => {
  drag = {x: e.clientX, y: e.clientY, btn: e.button}; e.preventDefault();
});
window.addEventListener('mouseup', () => drag = null);
window.addEventListener('mousemove', e => {
  if (!drag) return;
  const dx = (e.clientX - drag.x) / img.width;
  const dy = -(e.clientY - drag.y) / img.height;
  drag.x = e.clientX; drag.y = e.clientY;
  send({type: drag.btn === 2 ? 'move' : 'pan', dx, dy});
});
img.addEventListener('wheel', e => {
  e.preventDefault(); send({type:'zoom', delta: e.deltaY > 0 ? -1 : 1});
});
for (const id of ['rx','ry','rz']) {
  document.getElementById(id).addEventListener('input', () => send({
    type:'rot',
    rx:+document.getElementById('rx').value,
    ry:+document.getElementById('ry').value,
    rz:+document.getElementById('rz').value}));
}
</script></body></html>"""


class ViewerSession:
    """Render-on-demand session shared by the HTTP handlers."""

    def __init__(self, g, res, fov, depth, renderer="auto",
                 render_kwargs=None):
        from rtgs_tpu.viewer.orbit import OrbitState

        self.g = g
        self.res = res
        self.fov = fov
        self.depth = depth
        self.renderer = renderer
        self.render_kwargs = render_kwargs or {}
        self.state = OrbitState()
        self.lock = threading.Lock()
        self._frame = None

    def handle_event(self, ev: dict):
        with self.lock:
            t = ev.get("type")
            if t == "pan":
                self.state.pan(ev["dx"], ev["dy"])
            elif t == "move":
                self.state.move_cursor(ev["dx"], ev["dy"])
            elif t == "zoom":
                self.state.zoom(float(ev["delta"]))
            elif t == "rot":
                self.state.set_global_rotation(
                    ev["rx"], ev["ry"], ev["rz"])
            self._frame = None

    def frame_png(self) -> bytes:
        with self.lock:
            if self._frame is None:
                self._frame = self._render()
            return self._frame

    def _render(self) -> bytes:
        from rtgs_tpu.camera import camera_from_fov, image_to_display
        from rtgs_tpu.render.api import render
        from rtgs_tpu.utils.image import encode_png, to_uint8

        pos, rot = self.state.camera_pose()
        cam = camera_from_fov(pos, rot, self.res, self.fov)
        img = render(self.g, cam, depth=self.depth,
                     renderer=self.renderer, **self.render_kwargs)
        return encode_png(to_uint8(np.asarray(image_to_display(img))))


def serve(g, args):
    """Entry point for the ``serve`` CLI command."""
    from rtgs_tpu.__main__ import render_kwargs

    session = ViewerSession(
        g, res=args.res, fov=args.fov, depth=args.depth,
        renderer=args.renderer, render_kwargs=render_kwargs(args))
    session.state.r = args.radius

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path.startswith("/frame"):
                data = session.frame_png()
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(data)
            else:
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.end_headers()
                self.wfile.write(_PAGE.encode())

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            try:
                ev = json.loads(self.rfile.read(length) or b"{}")
                session.handle_event(ev)
            except (ValueError, KeyError, TypeError) as e:
                self.send_response(400)
                self.end_headers()
                self.wfile.write(str(e).encode())
                return
            self.send_response(204)
            self.end_headers()

    server = ThreadingHTTPServer(("0.0.0.0", args.port), Handler)
    print(f"viewer: http://localhost:{args.port}  "
          f"({g.num} splats, {args.res[0]}x{args.res[1]})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
