#!/usr/bin/env python
"""Live web viewer: the interactive frontend over the engine facade.

The reference's user surface is the Trident-Forge editor (live viewport +
ImGuizmo transforms, ApplicationLayer.cpp:38-227, SceneViewportPanel.cpp:
63-100, plus the 9 editor panels under Trident-Forge/src/Panels/). The
JAX rebuild is headless-first, so the interactive surface is a localhost
web page streaming `present()` frames with panel equivalents:

  * orbit / pan / dolly editor camera (drag / shift-drag / wheel); Scene /
    Game viewport toggle (ID 1 editor camera / ID 2 runtime camera)
  * click-to-select (tri_id → entity picking); gizmo drag with the
    reference's three modes + W/E/R keyboard switching (the ImGuizmo
    analogue, SceneViewportPanel.cpp:63-100): translate in the camera
    plane, rotate (euler yaw/pitch), uniform scale
  * Hierarchy (entity list + destroy), Inspector (schema-driven component
    editing), Console (log ring + level filter, ConsolePanel analogue),
    Content browser (asset listing + import), Toolbar (play/stop, perf
    CSV capture, dataset capture, video recording), AI debug stats +
    blend slider (AIDebugPanel analogue)
  * play/stop with runtime-camera rebinding, primitive spawning, scene
    save/load

Run:  python scripts/viewer.py [--width 512 --height 512 --port 8642]
            [--model path.obj ...] [--scene file.trident] [--shadows]
            [--assets DIR]
Then open http://localhost:8642/ .

All engine access serializes through one lock (the renderer is a
single-threaded object, like the reference's render thread).
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_PAGE = """<!DOCTYPE html>
<html><head><title>trident viewer</title><style>
 body { margin:0; background:#14151a; color:#cfd2dc; font:13px monospace;
        display:flex; height:100vh; }
 #view { flex:1; display:flex; align-items:center; justify-content:center; }
 #frame { image-rendering:pixelated; cursor:grab; max-width:100%;
          max-height:100%; }
 #side { width:300px; padding:10px; overflow-y:auto; background:#1b1d24;
         border-left:1px solid #2a2d38; }
 button { background:#2a2d38; color:#cfd2dc; border:1px solid #3a3e4c;
          margin:2px; padding:4px 10px; cursor:pointer; }
 button.on { background:#3d6b4f; }
 .ent { padding:2px 6px; cursor:pointer; }
 .ent.sel { background:#31405c; }
 input { background:#14151a; color:#cfd2dc; border:1px solid #3a3e4c;
         width:56px; margin:1px; }
 h4 { margin:8px 0 4px; color:#8e93a5; }
 #stats { color:#7dc87d; }
</style></head><body>
<div id=view><img id=frame></div>
<div id=side>
  <div id=stats>--</div>
  <div>
    <button id=play onclick="act('play')">Play</button>
    <button onclick="act('stop')">Stop</button>
    <button id=vp onclick="toggleVp()">Scene</button>
    <button id=move onclick="toggleMove()">Move</button>
  </div>
  <div>
    <button onclick="spawn('cube')">+Cube</button>
    <button onclick="spawn('sphere')">+Sphere</button>
    <button onclick="spawn('quad')">+Quad</button>
  </div>
  <div>
    <button id=perf onclick="toggle('perf_capture', 'perf')">PerfCSV</button>
    <button id=data onclick="toggle('dataset_capture', 'data')">Dataset</button>
    <button id=rec onclick="toggle('record', 'rec')">Record</button>
  </div>
  <h4>AI <span id=aistats></span></h4>
  <input id=blend type=range min=0 max=100 value=0 style="width:240px"
         oninput="post('/api/ai_blend', {value: this.value / 100})">
  <h4>Entities</h4><div id=ents></div>
  <h4>Inspector</h4><div id=insp>click an entity in the viewport</div>
  <h4>Animation Graph</h4><div id=animgraph style="font-size:11px"></div>
  <h4>Assets <span id=adir></span></h4><div id=assets></div>
  <h4>Console <select id=lvl onchange="refreshConsole()">
    <option value=0>all</option><option value=20>info</option>
    <option value=30 selected>warn</option><option value=40>error</option>
  </select></h4>
  <div id=console style="font-size:11px; max-height:180px; overflow-y:auto">
  </div>
</div>
<script>
const img = document.getElementById('frame');
let sel = null, dragging = 0, lx = 0, ly = 0, moved = 0;
let vp = 1, gizmoMode = 0, flags = {};
const GIZMO = ['', 'translate', 'rotate', 'scale'];
function toggleVp() {
  vp = vp === 1 ? 2 : 1;
  document.getElementById('vp').textContent = vp === 1 ? 'Scene' : 'Game';
}
function setMode(m) {
  gizmoMode = m;
  const b = document.getElementById('move');
  b.textContent = m ? GIZMO[m][0].toUpperCase() + GIZMO[m].slice(1) : 'Move';
  b.className = m ? 'on' : '';
}
function toggleMove() { setMode(gizmoMode ? 0 : 1); }
// W/E/R gizmo mode keys, like the reference editor (SceneViewportPanel)
window.addEventListener('keydown', e => {
  if (e.target.tagName === 'INPUT' || e.target.tagName === 'SELECT') return;
  const k = e.key.toLowerCase();
  if (k === 'w') setMode(1);
  else if (k === 'e') setMode(2);
  else if (k === 'r') setMode(3);
  else if (k === 'escape') setMode(0);
});
async function toggle(api, btn) {
  flags[btn] = !flags[btn];
  const r = await post('/api/' + api, {enabled: flags[btn]});
  document.getElementById(btn).className = flags[btn] ? 'on' : '';
  if (r && r.path) console.log(api, r.path);
}
async function post(u, b) {
  const r = await fetch(u, {method:'POST', body: JSON.stringify(b||{})});
  return r.json();
}
async function act(a) { await post('/api/' + a); refreshState(); }
async function spawn(p) { await post('/api/spawn', {primitive: p}); refreshEnts(); }
async function loop() {
  try {
    const r = await fetch('/api/frame?vp=' + vp + '&t=' + Date.now());
    const b = await r.blob();
    const url = URL.createObjectURL(b);
    img.onload = () => URL.revokeObjectURL(url);
    img.src = url;
  } catch (e) {}
  requestAnimationFrame(loop);
}
img.onpointerdown = e => { dragging = e.buttons; lx = e.clientX; ly = e.clientY;
                           moved = 0; img.setPointerCapture(e.pointerId); };
img.onpointerup = async e => {
  if (!moved) {
    const r = img.getBoundingClientRect();
    const x = Math.floor((e.clientX - r.left) / r.width  * img.naturalWidth);
    const y = Math.floor((e.clientY - r.top)  / r.height * img.naturalHeight);
    const res = await post('/api/pick', {x: x, y: y});
    select(res.entity);
  }
  dragging = 0;
};
img.onpointermove = e => {
  if (!dragging) return;
  const dx = e.clientX - lx, dy = e.clientY - ly; lx = e.clientX; ly = e.clientY;
  moved += Math.abs(dx) + Math.abs(dy);
  if (gizmoMode && sel !== null && sel !== undefined)
    post('/api/gizmo', {entity: sel, dx: dx, dy: dy, mode: GIZMO[gizmoMode]});
  else if (e.shiftKey || dragging === 4)
    post('/api/camera', {op:'pan', dx:dx, dy:dy});
  else post('/api/camera', {op:'orbit', dx:dx, dy:dy});
};
img.onwheel = e => { e.preventDefault();
                     post('/api/camera', {op:'dolly', dy:e.deltaY}); };
img.oncontextmenu = e => e.preventDefault();
async function refreshEnts() {
  const r = await (await fetch('/api/entities')).json();
  const d = document.getElementById('ents');
  d.innerHTML = '';
  for (const e of r.entities) {
    const el = document.createElement('div');
    el.className = 'ent' + (e.id === sel ? ' sel' : '');
    el.textContent = '#' + e.id + ' ' + e.tag;
    el.onclick = () => select(e.id);
    d.appendChild(el);
  }
}
async function select(id) {
  sel = id; refreshEnts();
  const d = document.getElementById('insp');
  if (id === null || id === undefined) { d.textContent = 'nothing selected'; return; }
  const r = await (await fetch('/api/entity?id=' + id)).json();
  d.innerHTML = '';
  const del = document.createElement('button');
  del.textContent = 'Destroy';
  del.onclick = async () => { await post('/api/destroy', {entity: id});
                              sel = null; refreshEnts(); select(null); };
  d.appendChild(del);
  for (const [comp, fields] of Object.entries(r.components)) {
    const h = document.createElement('h4'); h.textContent = comp; d.appendChild(h);
    for (const [f, v] of Object.entries(fields)) {
      const row = document.createElement('div');
      row.textContent = f + ' ';
      if (Array.isArray(v)) {
        v.forEach((x, i) => {
          const inp = document.createElement('input');
          inp.value = (typeof x === 'number') ? +x.toFixed(4) : x;
          inp.onchange = async () => {
            const cur = (await (await fetch('/api/entity?id='+id)).json())
                        .components[comp][f];
            cur[i] = parseFloat(inp.value);
            post('/api/set', {entity:id, component:comp, field:f, value:cur});
          };
          row.appendChild(inp);
        });
      } else {
        const inp = document.createElement('input');
        inp.style.width = '120px';
        inp.value = v;
        inp.onchange = () => post('/api/set',
          {entity:id, component:comp, field:f,
           value: isNaN(parseFloat(inp.value)) ? inp.value
                : (Number.isInteger(v) && Number.isInteger(+inp.value)
                   ? parseInt(inp.value) : parseFloat(inp.value))});
        row.appendChild(inp);
      }
      d.appendChild(row);
    }
  }
  refreshAnimGraph(id);
}
async function refreshAnimGraph(id) {
  // AnimationGraphPanel analogue: layers/states/transitions + live
  // parameter editing when the selected entity runs a state machine
  const d = document.getElementById('animgraph');
  d.innerHTML = '';
  if (id === null || id === undefined) return;
  const r = await (await fetch('/api/animgraph?id=' + id)).json();
  if (!r.graph) {
    if (r.clip !== undefined)
      d.textContent = 'clip ' + r.clip + (r.playing ? ' [playing]' : '');
    return;
  }
  const g = r.graph;
  for (const p of g.parameters) {
    const row = document.createElement('div');
    row.textContent = p.type + ' ' + p.name + ' ';
    const inp = document.createElement('input');
    inp.value = p.value;
    inp.onchange = () => post('/api/anim_param',
      {entity: id, name: p.name, value: parseFloat(inp.value)});
    row.appendChild(inp);
    d.appendChild(row);
  }
  for (const layer of g.layers) {
    const h = document.createElement('div');
    h.textContent = 'layer ' + layer.name + ' w=' + layer.weight
      + (layer.additive ? ' additive' : '')
      + (layer.fading_from ? '  fading ' + layer.fading_from + '→'
         + layer.current : '');
    h.style.color = '#8e93a5';
    d.appendChild(h);
    for (const st of layer.states) {
      const row = document.createElement('div');
      row.textContent = (st.active ? '▶ ' : '   ') + st.name
        + '  [' + st.tree.type
        + (st.tree.parameter ? ':' + st.tree.parameter : '') + ']';
      if (st.active) row.style.color = '#7dc87d';
      d.appendChild(row);
    }
    for (const t of layer.transitions) {
      const row = document.createElement('div');
      row.textContent = '  ' + t.source + ' → ' + t.target + '  when '
        + t.conditions.map(c => c.parameter + ' ' + c.comparison + ' '
                           + c.threshold).join(' & ')
        + (t.has_exit_time ? ' @exit ' + t.exit_time : '');
      row.style.color = '#6b7085';
      d.appendChild(row);
    }
  }
}
async function refreshState() {
  const r = await (await fetch('/api/state')).json();
  document.getElementById('stats').textContent =
    r.fps.toFixed(1) + ' fps  ' + r.width + 'x' + r.height +
    '  ' + r.triangles + ' tris' + (r.playing ? '  [playing]' : '');
  document.getElementById('play').className = r.playing ? 'on' : '';
  const a = r.ai;
  document.getElementById('aistats').textContent = a.enabled
    ? 'q=' + a.queue_depth + ' ' + a.last_inference_ms.toFixed(1) + 'ms avg='
      + a.average_inference_ms.toFixed(1) + 'ms n=' + a.completed_count
    : '(off)';
}
async function refreshConsole() {
  const lvl = document.getElementById('lvl').value;
  const r = await (await fetch('/api/console?level=' + lvl)).json();
  const d = document.getElementById('console');
  d.innerHTML = '';
  for (const e of r.entries) {
    const el = document.createElement('div');
    el.textContent = e.level + ' ' + e.message;
    if (e.level === 'ERROR' || e.level === 'CRITICAL') el.style.color = '#e07a7a';
    else if (e.level === 'WARNING') el.style.color = '#d9b96a';
    d.appendChild(el);
  }
  d.scrollTop = d.scrollHeight;
}
async function refreshAssets(dir) {
  const r = await (await fetch('/api/assets' +
                   (dir ? '?dir=' + encodeURIComponent(dir) : ''))).json();
  document.getElementById('adir').textContent = r.dir;
  const d = document.getElementById('assets');
  d.innerHTML = '';
  for (const it of r.items) {
    const el = document.createElement('div');
    el.className = 'ent';
    el.textContent = (it.kind === 'dir' ? '[d] ' : '    ') + it.name;
    el.onclick = it.kind === 'dir'
      ? () => refreshAssets(it.path)
      : async () => { await post('/api/import', {path: it.path});
                      refreshEnts(); };
    d.appendChild(el);
  }
}
loop(); refreshEnts(); refreshAssets(); refreshConsole();
setInterval(refreshState, 1000); setInterval(refreshConsole, 3000);
</script></body></html>"""


class ViewerServer:
    """HTTP wrapper around an Application: one lock serializes all engine
    access (renderer state is single-threaded by design)."""

    def __init__(self, app, host: str = "127.0.0.1", port: int = 8642,
                 assets_root: str | None = None):
        self.app = app
        self.assets_root = os.path.abspath(assets_root or os.getcwd())
        self.lock = threading.Lock()
        self._frames = 0
        self._fps = 0.0
        self._fps_t0 = time.perf_counter()
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _q(self):
                q = self.path.split("?", 1)[1] if "?" in self.path else ""
                return dict(p.split("=", 1) for p in q.split("&") if "=" in p)

            def _json(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                try:
                    if path == "/":
                        body = _PAGE.encode()
                        self.send_response(200)
                        self.send_header("Content-Type", "text/html")
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                    elif path == "/api/frame":
                        png = viewer.frame_png(int(self._q().get("vp", 1)))
                        self.send_response(200)
                        self.send_header("Content-Type", "image/png")
                        self.send_header("Content-Length", str(len(png)))
                        self.end_headers()
                        self.wfile.write(png)
                    elif path == "/api/entities":
                        self._json(viewer.entities())
                    elif path == "/api/entity":
                        self._json(viewer.entity(int(self._q()["id"])))
                    elif path == "/api/animgraph":
                        self._json(viewer.animgraph(int(self._q()["id"])))
                    elif path == "/api/state":
                        self._json(viewer.state())
                    elif path == "/api/console":
                        self._json(viewer.console(
                            int(self._q().get("level", 0))))
                    elif path == "/api/assets":
                        from urllib.parse import unquote

                        d = self._q().get("dir")
                        self._json(viewer.assets(unquote(d) if d else None))
                    else:
                        self._json({"error": "not found"}, 404)
                except Exception as exc:  # surface errors to the page
                    self._json({"error": str(exc)}, 500)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                path = self.path.split("?")[0]
                try:
                    out = viewer.command(path.removeprefix("/api/"), body)
                    self._json(out if out is not None else {"ok": True})
                except Exception as exc:
                    self._json({"error": str(exc)}, 500)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]

    # -- engine ops (all under the lock) ---------------------------------------
    def frame_png(self, viewport: int = 1) -> bytes:
        from PIL import Image

        with self.lock:
            t_in = time.perf_counter()
            self._bind_engine_thread()
            self.app.update()
            r = self.app.renderer
            vid = r.active_viewport
            if viewport == 2:  # game viewport (runtime camera when playing)
                if r.GAME_VIEWPORT not in r.viewports:
                    ctx = r.viewports[vid]
                    r.set_viewport(r.GAME_VIEWPORT, ctx.width, ctx.height)
                vid = r.GAME_VIEWPORT
            frame = r.present(vid)
            self._last_vp = vid
            # the viewer loop bypasses Application.render(), so feed the
            # readback consumers (video recording, dataset capture, AI
            # cadence) here — otherwise the Record/Dataset/AI toolbar
            # toggles silently capture nothing
            self.app._post_frame(None, frame=np.asarray(frame))
            self._frames += 1
            now = time.perf_counter()
            # the viewer loop bypasses draw_frame, so feed the timing ring
            # (and any active perf-capture session) from its own cadence
            ctx = r.viewports[vid]
            # first frame has no previous timestamp — fall back to this
            # call's own duration so a capture session spanning only the
            # first frame still records a sample
            last = getattr(self, "_last_frame_t", t_in)
            self._last_frame_t = now
            if now > last:
                r.timing.accumulate((now - last) * 1000.0,
                                    (ctx.width, ctx.height))
            if now - self._fps_t0 >= 1.0:
                self._fps = self._frames / (now - self._fps_t0)
                self._frames = 0
                self._fps_t0 = now
        buf = io.BytesIO()
        Image.fromarray(np.asarray(frame)).save(buf, format="PNG")
        return buf.getvalue()

    def entities(self):
        from trident.ecs.components import TagComponent

        with self.lock:
            reg = self.app.renderer.registry
            out = []
            for e in reg.alive():
                tag = reg.try_get(e, TagComponent)
                out.append({"id": int(e), "tag": tag.tag if tag else ""})
        return {"entities": out}

    def entity(self, eid: int):
        from trident.ecs.inspect import list_entity

        with self.lock:
            return {"id": eid,
                    "components": list_entity(self.app.renderer.registry, eid)}

    def animgraph(self, eid: int):
        """The AnimationGraphPanel analogue: the entity's animation state
        machine as a live graph (anim/graph_view.py), or its clip playback
        info when it plays a plain clip."""
        from trident.anim.graph_view import describe_state_machine
        from trident.ecs.components import AnimationComponent

        with self.lock:
            anim = self.app.renderer.registry.try_get(eid, AnimationComponent)
            if anim is None:
                return {"id": eid, "graph": None}
            out = {"id": eid, "playing": bool(anim.playing),
                   "speed": float(anim.speed), "time": float(anim.time),
                   "clip": anim.clip_name or anim.clip_index,
                   "graph": None}
            if anim.state_machine is not None:
                out["graph"] = describe_state_machine(anim.state_machine)
            return out

    def state(self):
        with self.lock:
            r = self.app.renderer
            ctx = r.viewports[r.active_viewport]
            ai = self.app.frame_generator.stats
            return {"fps": self._fps, "width": ctx.width, "height": ctx.height,
                    "playing": bool(self.app.scene.playing),
                    "models": r.stats_models, "triangles": r.stats_triangles,
                    "ai": {"enabled": ai.enabled,
                           "queue_depth": ai.queue_depth,
                           "completed_count": ai.completed_count,
                           "last_inference_ms": ai.last_inference_ms,
                           "average_inference_ms": ai.average_inference_ms}}

    def console(self, min_level: int = 0):
        from trident.core.log import ConsoleLog

        import logging

        entries = ConsoleLog.entries(min_level)[-120:]
        return {"entries": [{"level": logging.getLevelName(e.level),
                             "message": f"[{e.logger}] {e.message}"}
                            for e in entries]}

    def assets(self, directory: str | None = None):
        """Content-browser listing rooted at assets_root (the reference's
        ContentBrowserPanel roots at Assets/): subdirs + importable files."""
        from trident.assets.scene_loader import SUPPORTED_EXTENSIONS

        root = self.assets_root
        d = os.path.abspath(os.path.join(root, directory or "."))
        if not (d == root or d.startswith(root + os.sep)):
            d = root  # clamp escapes back to the root
        items = []
        try:
            names = sorted(os.listdir(d))
        except OSError:
            names = []
        for name in names:
            if name.startswith("."):
                continue
            full = os.path.join(d, name)
            rel = os.path.relpath(full, root)
            if os.path.isdir(full):
                items.append({"name": name, "path": rel, "kind": "dir"})
            elif os.path.splitext(name)[1].lower() in SUPPORTED_EXTENSIONS:
                items.append({"name": name, "path": rel, "kind": "model"})
        if d != root:
            items.insert(0, {"name": "..", "kind": "dir",
                             "path": os.path.relpath(os.path.dirname(d), root)})
        return {"dir": os.path.relpath(d, root), "items": items}

    def _bind_engine_thread(self):
        """ThreadingHTTPServer serves each request on its own thread; all
        engine access serializes through self.lock, so ownership transfer
        is race-free — tell the cross-thread mutation detector
        (core/threadcheck), when installed, that this is an intentional
        handoff. Call ONLY while holding self.lock."""
        rb = getattr(self.app.renderer.registry, "rebind_thread", None)
        if rb is not None:
            rb()

    def command(self, op: str, body: dict):
        from trident.ecs.inspect import set_field

        with self.lock:
            self._bind_engine_thread()
            app, r = self.app, self.app.renderer
            cam = r.editor_camera
            if op == "camera":
                kind = body.get("op")
                dx, dy = float(body.get("dx", 0)), float(body.get("dy", 0))
                if kind == "orbit":
                    lt = getattr(cam, "_look_target", None)
                    pivot = lt[0] if lt else np.zeros(3, np.float32)
                    cam.orbit(pivot, -dx * 0.4, -dy * 0.4)
                elif kind == "pan":
                    cam.pan(-dx * 0.01, dy * 0.01)
                elif kind == "dolly":
                    cam.dolly(-dy * 0.002)
            elif op == "pick":
                # pick against the viewport the client is LOOKING at (the
                # streamed one), not whatever active_viewport points to —
                # in Game view the two render with different cameras
                ent = r.pick_entity(int(body["x"]), int(body["y"]),
                                    viewport_id=getattr(self, "_last_vp",
                                                        None))
                return {"entity": ent}
            elif op == "anim_param":
                # AnimationGraphPanel edit path: write a state-machine
                # parameter (float/int/bool/trigger) on the entity
                from trident.anim.graph_view import set_parameter
                from trident.ecs.components import AnimationComponent

                anim = r.registry.try_get(int(body["entity"]),
                                          AnimationComponent)
                if anim is None or anim.state_machine is None:
                    raise ValueError("entity has no animation state machine")
                set_parameter(anim.state_machine, str(body["name"]),
                              body["value"])
            elif op == "gizmo":
                # ImGuizmo analogue with the reference's three modes
                # (SceneViewportPanel.cpp:63-100, W/E/R keyboard switching):
                #   translate — drag in the camera plane, scaled by distance
                #     (one pixel of drag tracks ~one pixel of screen motion)
                #   rotate    — dx spins yaw (euler Y), dy pitches (euler X)
                #   scale     — vertical drag scales uniformly (exp curve,
                #     clamped positive)
                from trident.ecs.components import TransformComponent

                t = r.registry.try_get(int(body["entity"]), TransformComponent)
                mode = body.get("mode", "translate")
                if t is not None and mode == "translate":
                    right, up, _fwd = cam._basis()
                    dist = float(np.linalg.norm(
                        np.asarray(t.position, np.float32) - cam.position))
                    ctx = r.viewports[r.active_viewport]
                    k = 2.0 * max(dist, 0.3) * np.tan(
                        np.radians(cam.fov_deg) / 2.0) / ctx.height
                    t.position = (np.asarray(t.position, np.float32)
                                  + right * float(body["dx"]) * k
                                  - up * float(body["dy"]) * k)
                elif t is not None and mode == "rotate":
                    rot = np.asarray(t.rotation, np.float32).copy()
                    rot[1] = (rot[1] + float(body["dx"]) * 0.5) % 360.0
                    rot[0] = (rot[0] + float(body["dy"]) * 0.5) % 360.0
                    t.rotation = rot
                elif t is not None and mode == "scale":
                    factor = float(np.exp(
                        (float(body["dx"]) - float(body["dy"])) * 0.005))
                    t.scale = np.maximum(
                        np.asarray(t.scale, np.float32) * factor,
                        1e-3).astype(np.float32)
            elif op == "destroy":
                r.registry.destroy(int(body["entity"]))
            elif op == "import":
                full = os.path.abspath(
                    os.path.join(self.assets_root, body["path"]))
                root = os.path.abspath(self.assets_root)
                # root + sep, not a bare prefix: "/assets-evil" must not
                # pass a "/assets" root (matches the /api/assets check)
                if not (full == root or full.startswith(root + os.sep)):
                    raise ValueError("path escapes the assets root")
                return {"entities": app.import_assets([full])}
            elif op == "ai_blend":
                app.config.ai.blend = float(body["value"])
            elif op == "perf_capture":
                if body.get("enabled"):
                    r.timing.begin_capture()
                else:
                    return {"path": r.timing.end_capture()}
            elif op == "dataset_capture":
                rec = app.dataset_recorder
                if body.get("dir"):
                    rec.directory = body["dir"]
                if body.get("interval"):
                    rec.interval_s = float(body["interval"])
                rec.start() if body.get("enabled") else rec.stop()
            elif op == "record":
                enc = app.video_encoder
                if body.get("enabled") and not enc.active:
                    ctx = r.viewports[r.active_viewport]
                    ok = enc.begin_session(body.get("path", "capture.y4m"),
                                           ctx.width, ctx.height,
                                           int(body.get("fps", 30)))
                    return {"ok": bool(ok)}
                if not body.get("enabled") and enc.active:
                    enc.end_session()
            elif op == "play":
                app.scene.play()
                r.set_active_registry(app.scene.runtime_registry)
                r.bind_runtime_camera(app.scene.runtime_registry)
            elif op == "stop":
                app.scene.stop()
                r.set_active_registry(app.scene.editor_registry)
                r.runtime_camera_ready = False
            elif op == "spawn":
                from trident.ecs.components import (
                    MeshComponent, TagComponent, TransformComponent)
                from trident.geometry.primitives import PrimitiveType

                prim = {"cube": PrimitiveType.CUBE,
                        "sphere": PrimitiveType.SPHERE,
                        "quad": PrimitiveType.QUAD}[body["primitive"]]
                reg = r.registry
                e = reg.create()
                reg.add(e, TransformComponent())
                reg.add(e, TagComponent(tag=body["primitive"]))
                reg.add(e, MeshComponent(mesh_index=r.ensure_primitive(prim)))
                return {"entity": int(e)}
            elif op == "set":
                set_field(r.registry, int(body["entity"]), body["component"],
                          body["field"], body["value"])
            elif op == "save":
                app.scene.save(body["path"])
            elif op == "load":
                app.scene.load(body["path"])
                r.set_active_registry(app.scene.editor_registry)
            else:
                raise ValueError(f"unknown command {op}")
        return None

    def serve_forever(self):
        self.httpd.serve_forever()

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def build_app(args):
    from trident.app import Application
    from trident.core.config import EngineConfig, RenderConfig
    from trident.ecs.components import (
        LightComponent, LightType, MeshComponent, TagComponent,
        TextureComponent, TransformComponent)
    from trident.geometry.primitives import PrimitiveType
    from trident.io.image import checkerboard

    cfg = EngineConfig(render=RenderConfig(
        width=args.width, height=args.height, shadows=args.shadows))
    app = Application(cfg)
    reg = app.scene.editor_registry
    if args.scene:
        app.scene.load(args.scene)
        app.renderer.set_active_registry(app.scene.editor_registry)
    if args.model:
        app.import_assets(args.model)
    if not args.scene and not args.model:
        slot = app.renderer.acquire_texture("checker", checkerboard(128, 8))
        for name, pos, prim in (("cube", [-1.1, 0, 0], PrimitiveType.CUBE),
                                ("sphere", [1.1, 0, 0], PrimitiveType.SPHERE)):
            e = reg.create()
            t = reg.add(e, TransformComponent())
            t.position = np.asarray(pos, np.float32)
            reg.add(e, TagComponent(tag=name))
            reg.add(e, MeshComponent(
                mesh_index=app.renderer.ensure_primitive(prim)))
            reg.add(e, TextureComponent(path="checker", slot=slot))
        sun = reg.create()
        reg.add(sun, TransformComponent())
        lc = reg.add(sun, LightComponent(light_type=LightType.DIRECTIONAL))
        lc.direction = np.asarray([-0.4, -1.0, -0.35], np.float32)
        reg.add(sun, TagComponent(tag="sun"))
    app.renderer.editor_camera.set_position([0, 1.2, 4.5])
    app.renderer.editor_camera.look_at_target([0, 0, 0])
    return app


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--height", type=int, default=512)
    parser.add_argument("--port", type=int, default=8642)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--model", action="append", default=[])
    parser.add_argument("--scene", default=None)
    parser.add_argument("--shadows", action="store_true")
    parser.add_argument("--assets", default=None,
                        help="content-browser root (default: cwd)")
    parser.add_argument("--cpu", action="store_true",
                        help="force the CPU backend")
    args = parser.parse_args(argv)

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")

    app = build_app(args)
    server = ViewerServer(app, args.host, args.port,
                          assets_root=args.assets)
    print(f"viewer: http://{args.host}:{server.port}/  (ctrl-c to stop)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        app.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
