"""Web display client: the GuiPass replacement for remote card hosts.

Counterpart of pupiloptixlab_tpu/display/web.py. The reference GUI is 1.1k
LoC of Win32 + DX12 + ImGui (system/gui/gui.cpp): a docked console
(start/stop, ms/FPS, tone-map + gamma toggles, displayable-buffer selector,
per-pass inspectors, gui.cpp:518-623), a scene panel (camera editor, object
list with visibility + ImGuizmo transforms, gui.cpp:689-816), a canvas
capturing mouse drag / wheel / WASDQE (gui.cpp:652-686), and menu actions
(load scene, screenshot -> EXR, gui.cpp:467-486). None of that maps to a
card in a machine with no display; the answer is a web client:

* frames stream as MJPEG over HTTP (multipart/x-mixed-replace) from the
  same flip-model double buffer the reference uses (gui.h:92-104,
  implemented in DisplayClient);
* the console/scene panels are a single embedded HTML page talking to a
  small JSON API; every control routes through the SAME event bus and
  RenderObject methods the reference's ImGui widgets call, so dirty
  propagation (camera edit -> accum reset, transform edit -> device refit)
  is identical;
* stdlib http.server only; /frame.png is encoded with zlib, so only the
  MJPEG stream needs a package (Pillow, imported when a stream opens).

The HTTP threads edit the world while the render thread draws frames:
every route that reads or edits the world, the passes or the buffers holds
``System._render_mutex``, so an edit takes effect between two frames.
"scene" stops rendering and loads on a thread of its own; its flatten
runs on the system's device from that thread, under the same mutex
(``System.set_scene``).

Endpoints:
  GET  /               the UI page
  GET  /stream         MJPEG frame stream of the selected buffer
  GET  /frame.png      one PNG frame (handy for headless screenshots)
  GET  /api/state      console + scene state (JSON)
  POST /api/select     {"name": buffer}         (buffer dropdown)
  POST /api/input      {"type": "drag"|"wheel"|"key", ...} (canvas input)
  POST /api/display    {"tone_mapping"?, "gamma"?} toggles
  POST /api/render     {"action": "start"|"stop"}
  POST /api/pass       {"name", "enabled"? , "set"?: {attr: value}}
  POST /api/camera     {"fov"?, "sensitivity"?}
  POST /api/object     {"name", "visible"?, "translate"?, "rotate"?,
                        "scale"?, "matrix"?}   (numeric edits)
  POST /api/pick       {"x", "y"} normalized canvas coords -> nearest
                       visible object under the cursor (viewport select)
  POST /api/objdrag    {"name", "dx", "dy", "mode": "translate"|
                        "rotate"|"scale"} in-canvas direct manipulation
                       (the ImGuizmo::Manipulate analog,
                       gui.cpp:689-702: ctrl/shift/alt + drag)
  POST /api/screenshot {"path"?} -> saves EXR (default images/)
  POST /api/scene      {"path"} -> async scene load (gui.cpp:852-869)
"""

from __future__ import annotations

import io
import json
import struct
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np

from pupiloptixlab_tpu_torch.display.client import DisplayClient
from pupiloptixlab_tpu_torch.utils.camera import Camera
from pupiloptixlab_tpu_torch.utils.event import CAMERA_CHANGE, START_RENDERING
from pupiloptixlab_tpu_torch.utils.log import get_logger
from pupiloptixlab_tpu_torch.utils.math import Transform

log = get_logger(__name__)


def _to_u8(img: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint8:  # already display-encoded on device
        return img
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _encode_jpeg(img: np.ndarray, quality: int = 85) -> bytes:
    from PIL import Image

    u8 = _to_u8(img)
    buf = io.BytesIO()
    Image.fromarray(u8).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _encode_png(img: np.ndarray) -> bytes:
    """8-bit grey, RGB or RGBA PNG of an (h, w[, c]) image, filter 0 on
    every row, zlib at its default level (no package needed)."""
    u8 = _to_u8(img)
    h, w = u8.shape[:2]
    c = 1 if u8.ndim == 2 else u8.shape[2]
    rows = np.zeros((h, 1 + w * c), np.uint8)  # each row: filter byte 0, then pixels
    rows[:, 1:] = u8.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2, 4: 6}[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _png_chunk(b"IEND", b""))


class WebDisplay(DisplayClient):
    """DisplayClient whose ``run()`` serves the GUI over HTTP."""

    def __init__(self, system, host: str = "127.0.0.1", port: int = 8090):
        super().__init__(system)
        self.host = host
        self.port = port
        self._server: ThreadingHTTPServer | None = None

    # -- state for /api/state ------------------------------------------------
    def console_state(self) -> dict:
        sys_ = self.system
        with sys_._render_mutex:  # a scene load swaps the objects under us
            objects = []
            if sys_.world.scene is not None:
                for ro in sys_.world.render_objects:
                    objects.append(
                        {
                            "name": ro.name,
                            "visible": ro.visible,
                            "matrix": np.asarray(
                                ro.transform.matrix, np.float32
                            ).reshape(-1).tolist(),
                        }
                    )
            cam = sys_.world.camera
            return {
                "fps": round(self.fps, 1),
                "frame_time_ms": round(self.frame_time_ms, 3),
                "rendering": sys_._render_flag.is_set(),
                "buffers": self.buffer_names(),
                "selected": self.selected,
                "tone_mapping": self.tone_mapping,
                "gamma": self.gamma,
                "passes": [p.inspector() for p in sys_.pre_passes + sys_.passes],
                "objects": objects,
                "camera": {
                    "fov": float(cam._fov_y) if cam else 0.0,
                    "sensitivity": float(Camera.sensitivity),
                },
            }

    # -- viewport manipulation (the ImGuizmo analog) --------------------------
    def pick_object(self, nx: float, ny: float):
        """Nearest visible object whose world AABB the pick ray hits.

        The ray replicates the device raygen (render/camera.py:
        sample_to_camera -> perspective divide -> camera_to_world), so a
        pick lands on the same object the pixel shows; AABB granularity
        matches the reference's scene-panel selection (gui.cpp:689-702
        selects whole RenderObjects, not primitives)."""
        with self.system._render_mutex:  # a scene load swaps the objects under us
            world = self.system.world
            cam = world.camera
            if cam is None or world.scene is None:
                return None, 0.0
            p = cam.sample_to_camera @ np.array([nx, ny, 0.0, 1.0], np.float32)
            d = p[:3] / p[3]
            c = cam.to_world
            dw = c[:3, :3] @ (d / np.linalg.norm(d))
            dw /= np.linalg.norm(dw)
            o = c[:3, 3]
            with np.errstate(divide="ignore"):
                inv = np.where(np.abs(dw) < 1e-12, 1e12, 1.0 / dw)
            best, best_t = None, np.inf
            for ro in world.render_objects:
                shape = ro.instance.shape
                if not ro.visible or shape is None or not shape.aabb.valid:
                    continue
                box = shape.aabb.transform(ro.instance.transform.matrix)
                t0 = (box.min - o) * inv
                t1 = (box.max - o) * inv
                tn = float(np.minimum(t0, t1).max())
                tf = float(np.maximum(t0, t1).min())
                if tn <= tf and tf > 0.0 and tn < best_t:
                    best, best_t = ro.name, max(tn, 0.0)
            return best, best_t

    def drag_object(self, name: str, ndx: float, ndy: float,
                    mode: str = "translate") -> bool:
        """Screen-space direct manipulation of one object. ndx/ndy are
        mouse deltas in canvas-height fractions (y down).

        translate: moves in the camera's right/up plane, scaled so the
        object tracks the cursor (world units per canvas height at the
        object's distance = 2 d tan(fov/2) — the ImGuizmo translate
        behavior); rotate: yaw around world Y (ndx) and pitch around the
        camera right axis (ndy), about the object center; scale: uniform
        about the center, drag up to grow. All three route through
        RenderObject.apply_transform -> RENDER_INSTANCE_TRANSFORM, the
        same dirty chain as the reference (render_object.cpp:46-48)."""
        with self.system._render_mutex:  # the edit lands between two frames
            world = self.system.world
            ro = world.get_render_object(name)
            cam = world.camera
            if ro is None or cam is None:
                return False
            shape = ro.instance.shape
            box = (
                shape.aabb.transform(ro.instance.transform.matrix)
                if shape is not None and shape.aabb.valid
                else None
            )
            center = (
                (box.min + box.max) * 0.5 if box is not None
                else ro.instance.transform.matrix[:3, 3]
            )
            right, up, _fwd = cam.coordinate_system()
            if mode == "translate":
                dist = float(np.linalg.norm(center - cam.position))
                k = 2.0 * dist * np.tan(np.deg2rad(cam.fov_y) * 0.5)
                delta = right * (ndx * k) - up * (ndy * k)
                ro.apply_transform(Transform().translate(*delta.tolist()))
                return True
            tc = Transform().translate(*center.tolist()).matrix
            tc_inv = Transform().translate(*(-center).tolist()).matrix
            if mode == "rotate":
                r = Transform().rotate(0.0, 1.0, 0.0, ndx * 180.0).matrix
                r = Transform().rotate(*right.tolist(), ndy * 180.0).matrix @ r
                ro.apply_transform(Transform(tc @ r @ tc_inv))
                return True
            if mode == "scale":
                s = float(np.clip(1.0 - ndy, 0.05, 20.0))
                ro.apply_transform(
                    Transform(tc @ Transform().scale(s, s, s).matrix @ tc_inv)
                )
                return True
            return False

    # -- actions (each routes through the reference's event/edit paths) ------
    def apply_action(self, route: str, body: dict) -> dict:
        sys_ = self.system
        if route == "select":
            self.select_buffer(str(body["name"]))
        elif route == "input":
            kind = body.get("type")
            if kind == "drag":
                self.mouse_drag(float(body["dx"]), float(body["dy"]))
            elif kind == "wheel":
                self.mouse_wheel(float(body["delta"]))
            elif kind == "key":
                self.key(str(body["key"]))
        elif route == "display":
            if "tone_mapping" in body:
                self.tone_mapping = bool(body["tone_mapping"])
            if "gamma" in body:
                self.gamma = bool(body["gamma"])
        elif route == "render":
            if body.get("action") == "start":
                sys_.events.dispatch(START_RENDERING)
            else:
                sys_.stop()
        elif route in ("pass", "camera", "object"):
            with sys_._render_mutex:  # the edit lands between two frames
                return self._edit(route, body)
        elif route == "pick":
            name, t = self.pick_object(float(body["x"]), float(body["y"]))
            return {"ok": True, "name": name, "t": round(float(t), 4)}
        elif route == "objdrag":
            ok = self.drag_object(
                str(body["name"]), float(body["dx"]), float(body["dy"]),
                str(body.get("mode", "translate")),
            )
            return {"ok": ok}
        elif route == "screenshot":
            path = body.get("path") or str(
                Path("images") / f"screenshot_{int(time.time())}.exr"
            )
            Path(path).parent.mkdir(parents=True, exist_ok=True)
            self.save_screenshot(path)
            return {"ok": True, "path": path}
        elif route == "scene":
            # stop, zero the canvas, load async (gui.cpp:852-869)
            sys_.stop()
            threading.Thread(
                target=sys_.set_scene, args=(body["path"],), daemon=True
            ).start()
        else:
            return {"ok": False, "error": f"unknown route {route}"}
        return {"ok": True}

    def _edit(self, route: str, body: dict) -> dict:
        """The "pass", "camera" and "object" routes (under the mutex)."""
        sys_ = self.system
        if route == "pass":
            name = body.get("name")
            for p in sys_.pre_passes + sys_.passes:
                if p.name == name:
                    if "enabled" in body:
                        p.enabled = bool(body["enabled"])
                    for key, value in (body.get("set") or {}).items():
                        setter = getattr(p, f"set_{key}", None)
                        if setter is not None:
                            setter(value)
                        elif hasattr(p, key):
                            setattr(p, key, value)
        elif route == "camera":
            cam = sys_.world.camera
            if cam is not None and "fov" in body:
                cam.set_fov(float(body["fov"]))
                sys_.world._camera_dirty = True
                sys_.events.dispatch(CAMERA_CHANGE)
            if "sensitivity" in body:
                Camera.sensitivity = float(body["sensitivity"])
        elif route == "object":
            ro = sys_.world.get_render_object(str(body["name"]))
            if ro is None:
                return {"ok": False, "error": "no such object"}
            if "visible" in body:
                ro.set_visible(bool(body["visible"]))
            t = None
            if "matrix" in body:
                m = np.asarray(body["matrix"], np.float32).reshape(4, 4)
                ro.update_transform(Transform(m))
            if "translate" in body:
                t = Transform().translate(*[float(v) for v in body["translate"]])
            if "rotate" in body:
                ax, ay, az, deg = (float(v) for v in body["rotate"])
                t = Transform().rotate(ax, ay, az, deg)
            if "scale" in body:
                t = Transform().scale(*[float(v) for v in body["scale"]])
            if t is not None:
                ro.apply_transform(t)
        return {"ok": True}

    # -- server ----------------------------------------------------------------
    def start(self) -> None:
        display = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _json(self, payload, code=200):
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/" or self.path.startswith("/index"):
                    page = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(page)))
                    self.end_headers()
                    self.wfile.write(page)
                elif self.path.startswith("/api/state"):
                    self._json(display.console_state())
                elif self.path.startswith("/frame.png"):
                    img = display.latest_image()
                    if img is None:
                        self.send_response(503)
                        self.end_headers()
                        return
                    data = _encode_png(img)
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif self.path.startswith("/stream"):
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=frame",
                    )
                    self.end_headers()
                    try:
                        while not display.system._quit_flag.is_set():
                            img = display.latest_image()
                            if img is not None:
                                data = _encode_jpeg(img)
                                self.wfile.write(b"--frame\r\n")
                                self.wfile.write(b"Content-Type: image/jpeg\r\n")
                                self.wfile.write(
                                    f"Content-Length: {len(data)}\r\n\r\n".encode()
                                )
                                self.wfile.write(data)
                                self.wfile.write(b"\r\n")
                            time.sleep(1.0 / 15.0)
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                else:
                    self.send_response(404)
                    self.end_headers()

            def do_POST(self):
                if not self.path.startswith("/api/"):
                    self.send_response(404)
                    self.end_headers()
                    return
                route = self.path[len("/api/"):]
                length = int(self.headers.get("Content-Length") or 0)
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                    # semantic failures ride a 200 {ok: false, error}
                    self._json(display.apply_action(route, body))
                except Exception as exc:  # malformed request
                    self._json({"ok": False, "error": str(exc)}, 400)

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._server.server_address[1]  # resolve port 0
        thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        thread.start()
        log.info("web display at http://%s:%d/", self.host, self.port)

    def run(self, refresh_hz: float = 30.0) -> None:
        """Serve until the system quits (the 'GUI thread')."""
        if self._server is None:
            self.start()
        while not self.system._quit_flag.is_set():
            time.sleep(0.1)
        self.shutdown()

    def shutdown(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()  # the listening socket
            self._server = None


_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>pupiloptixlab_tpu_torch</title>
<style>
 body{margin:0;display:flex;font:13px system-ui;background:#15171a;color:#d7dae0}
 #panel{width:320px;padding:10px;overflow-y:auto;height:100vh;box-sizing:border-box;background:#1d2024}
 #canvaswrap{flex:1;display:flex;align-items:center;justify-content:center;height:100vh}
 img#canvas{max-width:100%;max-height:100%;outline:none;image-rendering:auto}
 h3{margin:12px 0 4px;font-size:12px;text-transform:uppercase;color:#8b93a1}
 .row{display:flex;justify-content:space-between;align-items:center;margin:3px 0}
 select,input[type=number],input[type=text]{background:#2a2e34;color:#d7dae0;border:1px solid #3a3f46;border-radius:3px;padding:2px 4px}
 button{background:#2f6fed;border:0;color:#fff;border-radius:3px;padding:3px 10px;cursor:pointer;margin-right:4px}
 button.sec{background:#3a3f46}
 .obj{border:1px solid #2a2e34;border-radius:4px;padding:5px;margin:4px 0}
 .nudge button{padding:1px 6px;font-size:11px}
</style></head><body>
<div id="panel">
 <h3>Console</h3>
 <div class="row"><span id="fps">-- fps</span><span id="ms">-- ms</span></div>
 <div class="row">
  <button onclick="api('render',{action:'start'})">start</button>
  <button class="sec" onclick="api('render',{action:'stop'})">stop</button>
  <button class="sec" onclick="api('screenshot',{})">screenshot</button>
 </div>
 <div class="row"><label>buffer</label><select id="buffer" onchange="api('select',{name:this.value})"></select></div>
 <div class="row"><label>tone map</label><input id="tm" type="checkbox" onchange="api('display',{tone_mapping:this.checked})"></div>
 <div class="row"><label>gamma</label><input id="gm" type="checkbox" onchange="api('display',{gamma:this.checked})"></div>
 <h3>Passes</h3><div id="passes"></div>
 <h3>Camera</h3>
 <div class="row"><label>fov</label><input id="fov" type="number" step="1" style="width:70px"
   onchange="api('camera',{fov:parseFloat(this.value)})"></div>
 <div class="row"><label>sensitivity</label><input id="sens" type="number" step="0.1" style="width:70px"
   onchange="api('camera',{sensitivity:parseFloat(this.value)})"></div>
 <h3>Scene</h3>
 <div class="row"><input id="scenepath" type="text" placeholder="scene.xml" style="flex:1">
  <button onclick="api('scene',{path:document.getElementById('scenepath').value})">load</button></div>
 <div id="selinfo" style="color:#7dc4ff;font-size:11px;margin:3px 0"></div>
 <div id="objects"></div>
</div>
<div id="canvaswrap"><img id="canvas" src="/stream" tabindex="0"></div>
<script>
const api=(route,body)=>fetch('/api/'+route,{method:'POST',body:JSON.stringify(body)});
const canvas=document.getElementById('canvas');
// click = pick object under cursor; plain drag = camera orbit;
// ctrl/shift/alt + drag = translate/rotate/scale the selected object
// in-viewport (the ImGuizmo analog; the selected name is highlighted
// in the Scene panel and shown in #selinfo).
let dragging=false,px=0,py=0,moved=0,selected=null,dragMode=null;
function modeOf(e){return e.ctrlKey?'translate':e.shiftKey?'rotate':e.altKey?'scale':null;}
canvas.onmousedown=e=>{dragging=true;moved=0;px=e.clientX;py=e.clientY;
 dragMode=selected?modeOf(e):null;canvas.focus();};
window.onmouseup=async e=>{
 if(dragging&&moved<3&&e.target===canvas){
  const r=canvas.getBoundingClientRect();
  const res=await(await api('pick',{x:(e.clientX-r.left)/r.width,
                                    y:(e.clientY-r.top)/r.height})).json();
  selected=res.name;
  document.getElementById('selinfo').textContent=selected?('selected: '+selected+'  (ctrl-drag move, shift-drag rotate, alt-drag scale)'):'';
 }
 dragging=false;dragMode=null;};
window.onmousemove=e=>{if(!dragging)return;
 const dx=e.clientX-px,dy=e.clientY-py;moved+=Math.abs(dx)+Math.abs(dy);
 px=e.clientX;py=e.clientY;
 if(dragMode&&selected){
  const r=canvas.getBoundingClientRect();
  api('objdrag',{name:selected,dx:dx/r.height,dy:dy/r.height,mode:dragMode});
 }else{
  api('input',{type:'drag',dx:dx,dy:dy});
 }};
canvas.onwheel=e=>{e.preventDefault();api('input',{type:'wheel',delta:Math.sign(e.deltaY)});};
window.onkeydown=e=>{if('wasdqe'.includes(e.key)&&!e.ctrlKey&&!e.altKey)api('input',{type:'key',key:e.key});};
function nudge(name,axis,amt){const t=[0,0,0];t[axis]=amt;api('object',{name:name,translate:t});}
async function refresh(){
 try{
  const s=await (await fetch('/api/state')).json();
  document.getElementById('fps').textContent=s.fps+' fps';
  document.getElementById('ms').textContent=s.frame_time_ms+' ms';
  document.getElementById('tm').checked=s.tone_mapping;
  document.getElementById('gm').checked=s.gamma;
  if(document.activeElement.id!=='fov')document.getElementById('fov').value=s.camera.fov.toFixed(1);
  if(document.activeElement.id!=='sens')document.getElementById('sens').value=s.camera.sensitivity;
  const sel=document.getElementById('buffer');
  if(sel.options.length!==s.buffers.length){
   sel.innerHTML=s.buffers.map(b=>`<option${b===s.selected?' selected':''}>${b}</option>`).join('');
  }
  document.getElementById('passes').innerHTML=s.passes.map(p=>
   `<div class="row"><label><input type="checkbox" ${p.enabled?'checked':''}
      onchange="api('pass',{name:'${p.name}',enabled:this.checked})"> ${p.name}</label>
    <span>${p.time_ms} ms</span></div>`).join('');
  document.getElementById('objects').innerHTML=s.objects.map(o=>
   `<div class="obj"${o.name===selected?' style="border-color:#2f6fed"':''}><div class="row"><b>${o.name}</b>
     <label><input type="checkbox" ${o.visible?'checked':''}
      onchange="api('object',{name:'${o.name}',visible:this.checked})">visible</label></div>
    <div class="row nudge">${[0,1,2].map(a=>
      `<span>${'xyz'[a]} <button onclick="nudge('${o.name}',${a},-0.1)">-</button><button onclick="nudge('${o.name}',${a},0.1)">+</button></span>`).join('')}
    </div></div>`).join('');
 }catch(e){}
 setTimeout(refresh,1000);
}
refresh();
</script></body></html>
"""
