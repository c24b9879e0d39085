"""Interactive viewer application (the GUI shell, served over HTTP).

The reference wraps its tracer in an iced desktop app (survey C18-C21): an
Elm-architecture state machine with a render tab (start/stop, progress %,
config validation, click-to-debug) and a viewport tab (orbit/zoom/pan/look
camera controls, object picking, scene save). Accelerator hosts are
headless, so the equivalent shell here is a small HTTP app over the same
state machine:

    python -m path_tracer.viewer.app --port 8000

- ``GET  /``             single-page UI (vanilla JS)
- ``GET  /preview.png``  progressive raster+path-traced preview frame
- ``GET  /render.png``   latest full render
- ``GET  /state``        app state JSON (render progress, scenes, selection)
- ``POST /control``      {action: orbit|zoom|pan|look, dx, dy}
- ``POST /pick``         {relx, rely} → selected object (viewport picking)
- ``POST /probe``        {relx, rely} → debug ray result (render-tab click)
- ``POST /select_scene`` {id}
- ``POST /save_scene``   write scenes/<id>.json (reference Save button)
- ``POST /start_render`` {spp, res_y} (validated: res_y 1-2000, spp 1-10000)
- ``POST /stop_render``  cooperative cancel → partial image kept (§3.3)

State machine parity (main.rs:110-118): NotRendering → Pending → Rendering
{progress, stopping} → Done {seconds}.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

import path_tracer as pt
from path_tracer.render.image import encode_png
from path_tracer.utils.config import RenderConfig, Resolution, RES_Y_RANGE, SPP_RANGE
from path_tracer.utils.hashing import hash_bytes
from path_tracer.viewer.controls import SceneNavigator
from path_tracer.viewer.debug import test_scene_ray
from path_tracer.viewer.progressive import ProgressiveRenderer


def _png_bytes(rgb01: np.ndarray) -> bytes:
    arr = (np.clip(rgb01, 0, 1) * 255 + 0.5).astype(np.uint8)
    return encode_png(arr)


class ViewerState:
    """The app's mutable state (the reference's ``State``, main.rs:55-108)."""

    def __init__(self, scene_dir: str = "scenes", mesh_dir: str = "meshes",
                 preview_res: int = 160):
        self.scene_dir = scene_dir
        self.mesh_dir = mesh_dir
        self.scene_ids = pt.load_scene_ids(scene_dir, mesh_dir)
        self.scene = pt.load_scene("mesh" if "mesh" in self.scene_ids
                                   else self.scene_ids[0], scene_dir, mesh_dir)
        self.navigator = SceneNavigator(self.scene)
        self.preview = ProgressiveRenderer(
            self.scene, Resolution.from_height(preview_res)
        )
        self.selected_object: int | None = None
        # render state machine: not_rendering | pending | rendering | done
        self.render_state = "not_rendering"
        self.render_progress = 0.0
        self.render_seconds = 0.0
        self.render_error: str | None = None
        self.render_image: np.ndarray | None = None  # [H,W,3]
        self.render_hash: int = 0  # content hash of render_image (C15)
        self._cancel = threading.Event()
        self._render_thread: threading.Thread | None = None
        self._lock = threading.Lock()

    # --- preview / camera ---

    def preview_frame(self) -> tuple[bytes, str]:
        """(png, etag). The etag is the content hash (C15, mod.rs:916-926) —
        clients redraw only when it changes, the HTTP analog of the
        reference's hash-keyed canvas cache (render_tab.rs:240-326).

        Frames ride the uint8 transport (``step_u8``: on-device gamma +
        quantization, 4x smaller device fetch than the f32 ``step()``)."""
        frame = self.preview.step_u8()
        h, w = self.preview.resolution.height, self.preview.resolution.width
        # display orientation, as Image.to_grid: row 0 = PPM row 0
        grid = frame.reshape(h, w, 3)[::-1, ::-1, :]
        return encode_png(grid), f'"{hash_bytes(frame.tobytes()):x}"'

    def control(self, action: str, dx: float, dy: float):
        nav = self.navigator
        if action == "orbit":
            nav.orbit(dx, dy)
        elif action == "zoom":
            nav.zoom(dy)
        elif action == "pan":
            nav.pan(dx, dy)
        elif action == "look":
            nav.look_around(dx, dy, viewport_height=400.0)
        else:
            raise ValueError(f"unknown action {action!r}")
        if action != "orbit":
            nav.end_orbit()
        self.preview.move_camera(self.scene.camera)

    def pick(self, relx: float, rely: float):
        self.selected_object = self.navigator.pick_object(relx, rely, 1.5)
        return self.selected_object

    def probe(self, relx: float, rely: float):
        r = test_scene_ray(relx, rely, self.scene, packed=self.navigator.packed,
                           verbose=False)
        if r is None:
            return None
        return {
            "object_id": r.object_id,
            "distance": r.distance,
            "material": {
                "color": r.material.color.tolist(),
                "emission": r.material.emission.tolist(),
                "reflect_type": r.material.reflect_type.to_json(),
            },
        }

    def select_scene(self, scene_id: str):
        self.scene = pt.load_scene(scene_id, self.scene_dir, self.mesh_dir)
        self.navigator = SceneNavigator(self.scene)
        self.preview = ProgressiveRenderer(self.scene, self.preview.resolution)
        self.selected_object = None

    def save_scene(self) -> str:
        return self.scene.save(self.scene_dir)

    # --- full render (async worker, parity with render_worker main.rs:340) ---

    def start_render(self, spp: int, res_y: int):
        with self._lock:
            if self.render_state in ("pending", "rendering"):
                raise RuntimeError("render already in progress")
            cfg = RenderConfig(
                samples_per_pixel=spp,
                resolution=Resolution.from_height(res_y),
                validate=True,
            ).validated()
            self.render_state = "pending"
            self.render_progress = 0.0
            self.render_error = None
            self._cancel.clear()

        def worker():
            def progress(update):
                self.render_state = "rendering"
                self.render_progress = update.progress
                if update.image is not None:
                    self.render_image = update.image.to_grid()
                    self.render_hash = update.image.hash

            try:
                done = pt.render(
                    self.scene, cfg,
                    progress=progress, progress_interval=0.5,
                    cancel=self._cancel.is_set, verbose=False,
                )
                self.render_image = done.image.to_grid()
                self.render_hash = done.image.hash
                self.render_seconds = done.duration
                self.render_state = "done"
            except Exception as e:  # surface errors to the UI
                self.render_error = str(e)
                self.render_state = "not_rendering"

        self._render_thread = threading.Thread(target=worker, daemon=True)
        self._render_thread.start()

    def stop_render(self):
        self._cancel.set()

    def state_json(self) -> dict:
        return {
            "scenes": self.scene_ids,
            "scene": self.scene.id,
            "objects": [
                {"index": i, "kind": "Sphere" if o.is_sphere else "Mesh"}
                for i, o in enumerate(self.scene.objects)
            ],
            "selected_object": self.selected_object,
            "camera": {
                "position": self.scene.camera.position.tolist(),
                "direction": self.scene.camera.direction.tolist(),
            },
            "render_state": self.render_state,
            "render_progress": self.render_progress,
            "render_seconds": self.render_seconds,
            "render_error": self.render_error,
            "preview_samples": self.preview.samples_done,
        }


_PAGE = """<!doctype html><html><head><title>path_tracer</title>
<style>body{font-family:monospace;background:#111;color:#ddd;margin:20px}
img{image-rendering:pixelated;border:1px solid #444}
button,input,select{background:#222;color:#ddd;border:1px solid #555;margin:2px}
#sidebar{float:right;width:280px}.sel{background:#46a}</style></head><body>
<h3>path_tracer viewer</h3>
<div id=sidebar>
 <div>scene: <select id=scene onchange=selScene()></select>
  <button onclick="post('/save_scene',{})">save</button></div>
 <div id=objects></div>
 <div>spp <input id=spp value=100 size=5> res_y <input id=resy value=300 size=5>
  <button onclick=startRender()>render</button>
  <button onclick="post('/stop_render',{})">stop</button></div>
 <div id=status></div>
 <div>scroll=orbit shift=zoom ctrl=pan shift+ctrl=look; click=pick,
  alt+click=probe</div><pre id=probe></pre>
</div>
<img id=preview width=480>
<br><img id=render width=480 style="display:none">
<script>
async function post(u,b){return (await fetch(u,{method:'POST',
 body:JSON.stringify(b)})).json()}
async function refreshState(){let s=await (await fetch('/state')).json();
 let sel=document.getElementById('scene');
 if(sel.options.length==0){for(const id of s.scenes){let o=document.createElement('option');
  o.value=o.text=id;sel.add(o)}}
 sel.value=s.scene;
 document.getElementById('objects').innerHTML=s.objects.map(o=>
  `<div class="${o.index===s.selected_object?'sel':''}">${o.index} ${o.kind}</div>`).join('');
 document.getElementById('status').innerText=
  `state: ${s.render_state} ${(100*s.render_progress).toFixed(1)}% `+
  `${s.render_seconds?s.render_seconds.toFixed(2)+'s':''} preview spp: ${s.preview_samples}`+
  (s.render_error?` ERROR: ${s.render_error}`:'');
 if(s.render_state=='rendering'||s.render_state=='done'){
  let r=document.getElementById('render');r.style.display='block';
  let resp=await fetch('/render.png',{cache:'no-cache'});
  if(resp.status==200){let b=await resp.blob();
   let u=URL.createObjectURL(b);r.onload=()=>URL.revokeObjectURL(u);r.src=u}}}
function selScene(){post('/select_scene',{id:document.getElementById('scene').value})}
function startRender(){post('/start_render',{spp:+document.getElementById('spp').value,
 res_y:+document.getElementById('resy').value})}
let img=document.getElementById('preview');
async function refreshPreview(){try{
 let r=await fetch('/preview.png',{cache:'no-cache'});
 if(r.status==200){let b=await r.blob();
  let u=URL.createObjectURL(b);img.onload=()=>URL.revokeObjectURL(u);img.src=u}
 setTimeout(refreshPreview,200)}catch(e){setTimeout(refreshPreview,1000)}}
refreshPreview();setInterval(refreshState,700);
img.addEventListener('wheel',e=>{e.preventDefault();
 let a=e.shiftKey&&e.ctrlKey?'look':e.shiftKey?'zoom':e.ctrlKey?'pan':'orbit';
 post('/control',{action:a,dx:e.deltaX,dy:e.deltaY})});
img.addEventListener('click',async e=>{let r=img.getBoundingClientRect();
 let rx=(e.clientX-r.left)/r.width, ry=1-(e.clientY-r.top)/r.height;
 if(e.altKey){let p=await post('/probe',{relx:rx,rely:ry});
  document.getElementById('probe').innerText=JSON.stringify(p,null,1)}
 else await post('/pick',{relx:rx,rely:ry})});
</script></body></html>"""


def make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, body, ctype="application/json", etag=None):
            # etag: image-hash cache keying (the reference's canvas cache
            # is keyed by image hash, render_tab.rs:240-326) — a matching
            # If-None-Match answers 304 with no body, so pollers pay
            # nothing while the image is unchanged
            if etag is not None and self.headers.get("If-None-Match") == etag:
                self.send_response(304)
                self.send_header("ETag", etag)
                self.end_headers()
                return
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            if etag is not None:
                self.send_header("ETag", etag)
                self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?")[0]
            try:
                if path == "/":
                    self._send(200, _PAGE.encode(), "text/html")
                elif path == "/state":
                    self._send(200, json.dumps(state.state_json()).encode())
                elif path == "/preview.png":
                    png, etag = state.preview_frame()
                    self._send(200, png, "image/png", etag=etag)
                elif path == "/render.png":
                    img = state.render_image
                    if img is None:
                        self._send(404, b"{}")
                    else:
                        self._send(
                            200, _png_bytes(np.power(img, 1 / 2.2)),
                            "image/png", etag=f'"{state.render_hash:x}"',
                        )
                else:
                    self._send(404, b"{}")
            except BrokenPipeError:
                pass

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            path = self.path.split("?")[0]
            try:
                out = {}
                if path == "/control":
                    state.control(body["action"], float(body.get("dx", 0)),
                                  float(body.get("dy", 0)))
                elif path == "/pick":
                    out = {"selected": state.pick(body["relx"], body["rely"])}
                elif path == "/probe":
                    out = state.probe(body["relx"], body["rely"]) or {}
                elif path == "/select_scene":
                    state.select_scene(body["id"])
                elif path == "/save_scene":
                    out = {"path": state.save_scene()}
                elif path == "/start_render":
                    state.start_render(int(body["spp"]), int(body["res_y"]))
                elif path == "/stop_render":
                    state.stop_render()
                else:
                    self._send(404, b"{}")
                    return
                self._send(200, json.dumps(out).encode())
            except KeyError as e:
                self._send(400, json.dumps(
                    {"error": f"missing field {e} for {path}"}
                ).encode())
            except (ValueError, RuntimeError) as e:
                self._send(400, json.dumps({"error": str(e)}).encode())

    return Handler


def serve(port: int = 8000, scene_dir: str = "scenes", mesh_dir: str = "meshes"):
    state = ViewerState(scene_dir, mesh_dir)
    server = ThreadingHTTPServer(("127.0.0.1", port), make_handler(state))
    print(f"viewer at http://127.0.0.1:{port}/ — scenes: {state.scene_ids}")
    server.serve_forever()


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--scene-dir", default="scenes")
    p.add_argument("--mesh-dir", default="meshes")
    p.add_argument(
        "--cpu", action="store_true",
        help="render on the CPU backend (hosts without an accelerator)",
    )
    a = p.parse_args()
    if a.cpu:
        import jax

        # env vars are not enough here: the platform can be re-pinned after
        # import (see tests/conftest.py), so set it through jax.config
        jax.config.update("jax_platforms", "cpu")
    serve(a.port, a.scene_dir, a.mesh_dir)
