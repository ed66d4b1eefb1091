"""Interactive progressive viewer (counterpart of raytrace_tpu/viewer.py).

The reference's bin/src/app.rs runs a winit window: per-frame
acquire->render->present progressively refines the image (app.rs:286-305),
'o' opens a file dialog to hot-swap scenes keeping the old one on errors
(app.rs:263-283, 225-234), and resizing restarts accumulation
(app.rs:239-242).  Here, as in the JAX package, a tiny HTTP viewer: a
render thread refines the image chunk by chunk while a browser polls the
current accumulation; scene hot-swap (explicit or by watching the file's
mtime) and resize-restart follow the same semantics.

    python -m raytrace_tpu_torch.cli view scene.json [--port 8000]

Endpoints: `/` (auto-refreshing page), `/image.png` (current
accumulation), `/status` (JSON), `/reload?path=` (hot-swap; errors keep
the old scene), `/resize?width=&height=` (restart accumulation).

Where it differs from the JAX viewer:

- The render thread launches on the renderer's device: a kernel launch
  goes to the calling thread's current CUDA device, so the loop runs
  under ``torch.cuda.device(device)``.
- It steps as the port's Renderer does: a chunk of
  ``chunk_size()`` batches in one call on the "fused" and "fused_anim"
  paths (one launch), a batch at a time on the others.
- A hot-swap keeps the old scene only on what a scene file can cause
  (``SCENE_ERRORS``: the errors the CLI exits 2 on); anything else, such
  as a CUDA error or a failed kernel build, ends the render thread.
- An exception that ends the render thread is logged and shown as
  ``status()["error"]``; the page keeps serving the last image.
- ``png_bytes`` copies the accumulation off the card under the lock.
"""

from __future__ import annotations

import contextlib
import io
import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import torch

from .scene_file import SceneError

log = logging.getLogger("raytrace_tpu_torch")

# What loading and compiling a scene file can raise (a JSON decode error is
# a ValueError, a missing file an OSError): a hot-swap that fails with one
# of these keeps the old scene.
SCENE_ERRORS = (SceneError, OSError, ValueError, KeyError)

_PAGE = """<!doctype html>
<html><head><title>raytrace_tpu_torch viewer</title><style>
body {{ background:#111; color:#ddd; font-family:monospace; }}
img {{ image-rendering:pixelated; border:1px solid #444; }}
</style></head><body>
<h3>raytrace_tpu_torch — {scene}</h3>
<div id="status">…</div>
<p><img id="view" width="{dw}" src="/image.png"></p>
<form action="/resize"><input name="width" placeholder="width" size="6">
<input name="height" placeholder="height" size="6">
<button>resize (restarts)</button></form>
<form action="/reload"><input name="path" placeholder="scene path" size="48">
<button>load scene</button></form>
<script>
async function tick() {{
  const s = await (await fetch('/status')).json();
  document.getElementById('status').textContent =
    `batch ${{s.batch}}/${{s.total_batches}} — ` +
    `${{s.mrays_per_sec.toFixed(1)}} Mrays/s — ${{s.width}}x${{s.height}}` +
    (s.error ? ` — ${{s.error}}` : '');
  document.getElementById('view').src = '/image.png?b=' + s.batch +
    '&g=' + s.generation;
}}
setInterval(tick, 1000); tick();
</script></body></html>"""


class ViewerState:
    """Shared state between the render thread and HTTP handlers."""

    def __init__(self, scene_path: str, width=None, height=None,
                 device="cuda"):
        self.lock = threading.Lock()
        self.scene_path = self.width = self.height = None
        self.device = torch.device(device)
        self.renderer = None
        self.generation = 0          # bumps on reload/resize
        self.error = None            # the last failed hot-swap's message
        self.render_error = None     # what ended the render thread
        self.stop = False
        self._mtime = None
        self._pending = None         # (path, width, height) request
        self._build(os.path.abspath(scene_path), width, height)

    # -- build / swap -----------------------------------------------------

    def _build(self, path, width, height):
        """Load, compile and build the scene; it becomes the one rendered
        only once all of that has succeeded."""
        from .cli import load_scene
        from .engine import Renderer

        cs = load_scene(path, width, height)
        renderer = Renderer(cs, device=self.device)
        mtime = os.path.getmtime(path)
        with self.lock:
            self.scene_path, self.width, self.height = path, width, height
            self.renderer = renderer
            self.generation += 1
            self.error = None
            self._mtime = mtime

    def request(self, path=None, width=None, height=None):
        self._pending = (path or self.scene_path,
                         width or self.width, height or self.height)

    def _apply_pending(self):
        """Hot-swap semantics: a bad scene file logs the error and keeps
        the current render going (app.rs:225-234)."""
        req, self._pending = self._pending, None
        if req is None:
            return
        try:
            self._build(os.path.abspath(req[0]), req[1], req[2])
            log.info("viewer: loaded %s", self.scene_path)
        except SCENE_ERRORS as e:
            with self.lock:
                self.error = str(e)
            log.error("viewer: scene load failed, keeping old scene: %s", e)

    # -- render loop ------------------------------------------------------

    def render_loop(self):
        """Refine until ``stop``; an exception ends the loop and is kept
        as ``render_error``."""
        try:
            with (torch.cuda.device(self.device)
                  if self.device.type == "cuda" else contextlib.nullcontext()):
                self._loop()
        except Exception as e:
            with self.lock:
                self.render_error = f"{type(e).__name__}: {e}"
            log.exception("viewer: the render thread failed")

    def _loop(self):
        while not self.stop:
            if self._pending is not None:
                self._apply_pending()
            try:
                mt = os.path.getmtime(self.scene_path)
                if self._mtime is not None and mt != self._mtime:
                    log.info("viewer: %s changed on disk, reloading",
                             self.scene_path)
                    self.request()
                    self._mtime = mt
                    continue
            except OSError:
                pass
            r = self.renderer
            left = r.compiled.render.sample_batches - r.current_batch
            if left <= 0:
                time.sleep(0.25)
                continue
            if r.path in ("fused", "fused_anim"):
                r.render_batches(min(r.chunk_size(), left))
            else:
                r.render_next_batch()

    # -- views ------------------------------------------------------------

    def png_bytes(self) -> bytes:
        from PIL import Image

        from .utils.image import to_srgb_u8

        with self.lock:
            img = self.renderer.accum.cpu().numpy()
        buf = io.BytesIO()
        Image.fromarray(to_srgb_u8(img)).save(buf, format="PNG")
        return buf.getvalue()

    def status(self) -> dict:
        with self.lock:
            r = self.renderer
            return {
                "scene": self.scene_path,
                "batch": r.current_batch,
                "total_batches": r.compiled.render.sample_batches,
                "width": r.static.width,
                "height": r.static.height,
                "mrays_per_sec": r.stats.mrays_per_sec,
                "generation": self.generation,
                "error": self.render_error or self.error,
            }


def _make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):                    # quiet
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Cache-Control", "no-store")
            if code == 302:
                self.send_header("Location", "/")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            q = parse_qs(url.query)
            if url.path == "/":
                st = state.status()
                dw = min(1024, 2 * st["width"])
                page = _PAGE.format(scene=os.path.basename(st["scene"]),
                                    dw=dw)
                self._send(200, "text/html", page.encode())
            elif url.path == "/image.png":
                self._send(200, "image/png", state.png_bytes())
            elif url.path == "/status":
                self._send(200, "application/json",
                           json.dumps(state.status()).encode())
            elif url.path == "/reload":
                state.request(path=q.get("path", [None])[0])
                self._send(302, "text/plain", b"")
            elif url.path == "/resize":
                def _i(k):
                    v = q.get(k, [None])[0]
                    return int(v) if v else None
                state.request(width=_i("width"), height=_i("height"))
                self._send(302, "text/plain", b"")
            else:
                self._send(404, "text/plain", b"not found")

    return Handler


class Viewer:
    """Render thread + HTTP server pair; ``serve_forever`` blocks.  The
    first scene is loaded and its Renderer built by the constructor, on
    ``device`` (the card unless the CPU is asked for)."""

    def __init__(self, scene_path, width=None, height=None, port=8000,
                 host="127.0.0.1", device="cuda"):
        self.state = ViewerState(scene_path, width, height, device)
        self.httpd = ThreadingHTTPServer((host, port),
                                         _make_handler(self.state))
        self.port = self.httpd.server_address[1]
        self._render_thread = threading.Thread(
            target=self.state.render_loop, daemon=True)
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)

    def start(self):
        self._render_thread.start()
        self._http_thread.start()
        log.info("viewer: http://127.0.0.1:%d/", self.port)

    def stop(self, timeout: float = 60.0):
        """Stop serving and rendering; waits up to ``timeout`` seconds
        for the render thread's current step."""
        self.state.stop = True
        if self._http_thread.is_alive():
            self.httpd.shutdown()
        self.httpd.server_close()
        if self._render_thread.is_alive():
            self._render_thread.join(timeout)

    def serve_forever(self):
        self.start()
        try:
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            self.stop()
