"""Browser-based design studio: the application shell (studio.py of the JAX
package).

The reference is a desktop wxWidgets app (DesignCSG.cpp:331-452):
two Python editor tabs (the design file + ``designlibrary.py``), a 640x480
live viewport with mouse orbit/zoom, a debug console, design-file management
(New with a starter template / Open / Save / SaveAs / Delete backed by
``designPath.txt`` last-open persistence, DesignCSG.cpp:136-330), File->Run
(DesignCSG.cpp:531-568) and File->Export with a progress monitor thread
(DesignCSG.cpp:603-1031).

The framework is a library, so its shell is a zero-dependency local web
app on :mod:`http.server`: the same capabilities, drivable from a browser or
headlessly over HTTP (which is how the tests exercise it).  Design scripts
are written against the port's API (``designcsg_tpu_torch.api``: torch
brushes, each with an optional CUDA body).

* ``Workspace`` — design-file management on a directory, with the starter
  template and last-open persistence.
* ``StudioSession`` — run pipeline: exec the script against a fresh
  compiler, commit, build a renderer; console capture; camera orbit/zoom
  with the reference's handler semantics; background export with monitored
  progress.  It runs on ``device`` (default ``cuda``): the frames through
  the CUDA renderer for a scene with CUDA bodies, the export through the
  point and grid kernels.  Frames render under one lock, so a renderer's
  kernel launches from one thread at a time (ops/cuda/build.py
  ``stream_handle``).
* ``StudioServer``/``serve`` — the HTTP surface + embedded single-page UI.
"""

from __future__ import annotations

import io
import json
import os
import secrets
import threading
import time
import traceback
from contextlib import redirect_stderr, redirect_stdout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from . import resolve_device
from .camera import Camera
from .compiler import CompiledScene
from .config import RenderConfig

#: Starter contents for File->New (the reference writes a small script
#: template into fresh design files, DesignCSG.cpp:38-49).  Ours targets the
#: port's API: a brush is a torch function, with its CUDA body to run on the
#: card's kernels.
NEW_DESIGN_TEMPLATE = '''\
"""New design.  Edit and press Run (ctrl-enter)."""

import torch
from designcsg_tpu_torch import api
from designcsg_tpu_torch.api import Transform


def my_brush(v, ctx):
    # Signed distance at local points v[..., 3].
    return torch.linalg.vector_norm(v, dim=-1) - 0.5


# cuda: the same distance as a CUDA body over the local point (a, b, c);
# without one the design runs on the plain torch path.
brush = api.define_brush(my_brush, name="my_brush",
                         cuda="return sqrtf(a * a + b * b + c * c) - 0.5f;")
api.draw(brush, Transform.initial((0.0, 0.0, 0.0), 0.0, 0.0, 0.0, 1.0))
api.setExportConfig(boundingBoxHalfDiameter=1.0, gridLevel=7)
api.commit()
'''

LIBRARY_BASENAME = "designlibrary.py"

#: Starter contents for the workspace's designlibrary tab (the reference
#: ships an empty user-editable library, second editor tab,
#: DesignCSG.cpp:403-420).
LIBRARY_TEMPLATE = '''\
"""Workspace design library.

Anything defined here is importable from design scripts in this workspace
(the directory is on sys.path while a design runs).  The framework's own
prefab library is ``designcsg_tpu_torch.designs.library``.
"""
'''


class Workspace:
    """Design-file management over a directory of ``*.py`` scripts.

    Mirrors the reference's New/Open/Save/SaveAs/Delete menu plus the
    ``designPath.txt`` last-open persistence (DesignCSG.cpp:33-36,136-298).
    """

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        lib = self._path(LIBRARY_BASENAME)
        if not os.path.exists(lib):
            with open(lib, "w") as f:
                f.write(LIBRARY_TEMPLATE)

    def _path(self, name: str) -> str:
        if (
            not name
            or os.path.sep in name
            or (os.path.altsep and os.path.altsep in name)
            or name.startswith(".")
            or ".." in name
        ):
            raise ValueError(f"design name escapes the workspace: {name!r}")
        base = name if name.endswith(".py") else name + ".py"
        path = os.path.join(self.root, base)
        # Belt-and-braces containment check: the pattern filter above misses
        # platform oddities (e.g. Windows drive-relative "C:foo" names).
        root = os.path.realpath(self.root)
        if os.path.commonpath([os.path.realpath(path), root]) != root:
            raise ValueError(f"design name escapes the workspace: {name!r}")
        return path

    def list_designs(self) -> list:
        out = []
        for fn in sorted(os.listdir(self.root)):
            if fn.endswith(".py") and fn != LIBRARY_BASENAME:
                out.append(fn[:-3])
        return out

    def read(self, name: str) -> str:
        with open(self._path(name)) as f:
            return f.read()

    def write(self, name: str, text: str) -> None:
        path = self._path(name)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)

    def new(self, name: str) -> None:
        path = self._path(name)
        if os.path.exists(path):
            raise FileExistsError(f"design {name!r} already exists")
        self.write(name, NEW_DESIGN_TEMPLATE)

    def delete(self, name: str) -> None:
        if os.path.basename(self._path(name)) == LIBRARY_BASENAME:
            raise ValueError("cannot delete the design library")
        os.remove(self._path(name))

    # -- last-open persistence (designPath.txt analog) --
    @property
    def _last_path(self) -> str:
        return os.path.join(self.root, ".last_design")

    def get_last(self) -> Optional[str]:
        try:
            with open(self._last_path) as f:
                name = f.read().strip()
            return name if name in self.list_designs() else None
        except OSError:
            return None

    def set_last(self, name: str) -> None:
        with open(self._last_path, "w") as f:
            f.write(name)


class StudioSession:
    """Holds the live scene, camera, renderer, console, and export state.

    The reference equivalent is the MyFrame + BasicDrawPane pair: Run
    compiles the script and reloads the scene (DesignCSG.cpp:531-568 +
    DrawPane.cpp:243), the pane free-runs renders with mouse orbit
    (DrawPane.cpp:561-589), Export runs on a worker thread with a monitor
    (DesignCSG.cpp:839-851).
    """

    def __init__(
        self,
        workspace: Workspace,
        width: int = 640,
        height: int = 480,
        device=None,
    ):
        self.workspace = workspace
        # Per-session CSRF token: state-changing endpoints require it in an
        # X-Studio-Token header, which cross-origin "simple" requests cannot
        # set without a CORS preflight (that this server never grants).
        self.token = secrets.token_hex(16)
        self.device = resolve_device(device)
        self._width, self._height = width, height
        # The studio viewport is the interactive surface (the reference
        # free-runs its 640x480 pane): on the card it defaults to the
        # hit-preserving fast march (over-relaxed, with the cone prepass
        # when the viewport divides by its factor; cli render --fast).
        # Exports are unaffected (the export pipeline is exact-semantics),
        # and set_render_mode(exact=True) switches the viewport to exact k1
        # semantics so what you see is what the export refines (the
        # approximate modes can drop thin or far features, config.py of the
        # JAX package; the toggle is the opt-out).
        self.exact_render = False
        self.config = self._viewport_config(exact=False)
        self.camera = Camera.initial()
        self.scene: Optional[CompiledScene] = None
        self._render_fn = None
        self._frame: Optional[np.ndarray] = None
        self.console: list = []
        self._lock = threading.Lock()
        # Serializes render-vs-orbit from concurrent HTTP handler threads
        # (the reference serializes through the single wx idle loop).
        self._render_lock = threading.Lock()
        self.export_status: dict = {"state": "idle"}
        self._export_thread: Optional[threading.Thread] = None
        self._export_active = False

    def log(self, text: str) -> None:
        # The reference drains a mutexed logString into the console on idle
        # (DesignCSG.cpp:300-310,575-601); here the console is a capped list
        # served over HTTP.
        with self._lock:
            for line in text.rstrip("\n").split("\n"):
                self.console.append(line)
            del self.console[:-500]

    # -- run pipeline --
    def run_text(self, text: str, name: str = "<design>") -> bool:
        """Execute design-script text against a fresh compiler; on success
        commit and (re)build the renderer.  Script stdout/stderr and
        tracebacks land in the console (the reference's log.txt channel,
        DesignCSG.cpp:544,563)."""
        import sys

        from . import api

        buf = io.StringIO()
        compiler = api.new_design()
        namespace = {"__name__": "__design__", "__file__": name}
        # The workspace's designlibrary must re-import fresh each run (the
        # reference saves + re-execs both tabs on every File->Run).
        sys.modules.pop("designlibrary", None)
        sys.path.insert(0, self.workspace.root)
        try:
            with redirect_stdout(buf), redirect_stderr(buf):
                exec(compile(text, name, "exec"), namespace)
                if "build" in namespace and callable(namespace["build"]):
                    scene = namespace["build"]()
                else:
                    scene = api.commit(compiler)
        except Exception:
            self.log(buf.getvalue())
            self.log(traceback.format_exc())
            return False
        finally:
            try:
                sys.path.remove(self.workspace.root)
            except ValueError:
                pass
        out = buf.getvalue()
        if out:
            self.log(out)
        # Swap scene/renderer/frame under the render lock: an in-flight
        # render of the old scene must not repopulate the frame cache after
        # the invalidation (it would serve a stale old-scene frame).
        with self._render_lock:
            self.scene = scene
            self._build_renderer()
            self._frame = None
        self.log(
            f"ran {name}: {scene.num_objects} objects, "
            f"{scene.num_build_steps} tape commands"
        )
        return True

    def run_design(self, name: str) -> bool:
        ok = self.run_text(self.workspace.read(name), name=name)
        if ok:
            self.workspace.set_last(name)
        return ok

    def _viewport_config(self, exact: bool) -> RenderConfig:
        from .cli import fast_config

        config = RenderConfig(width=self._width, height=self._height)
        fast = (not exact) and self.device.type == "cuda"
        return fast_config(config) if fast else config

    def set_render_mode(self, exact: bool) -> None:
        """Switch the viewport between the fast hit-preserving march and
        exact k1 semantics; rebuilds the renderer for the live scene."""
        exact = bool(exact)
        if exact == self.exact_render:
            return
        self.exact_render = exact
        self.config = self._viewport_config(exact)
        if self.scene is not None:
            self._build_renderer()
        with self._lock:
            self._frame = None

    def _build_renderer(self):
        from .viewer import _make_render_fn

        self._render_fn = _make_render_fn(self.scene, self.config, self.device)

    @property
    def engine(self) -> Optional[str]:
        """The live renderer's route ("cuda" or "tape"), None before a Run."""
        return None if self._render_fn is None else self._render_fn.engine

    # -- viewport --
    def render(self) -> np.ndarray:
        if self.scene is None:
            raise RuntimeError("no scene loaded — run a design first")
        with self._render_lock:
            if self._frame is None:
                t0 = time.time()
                self._frame = self._render_fn(self.camera)
                self.log(f"rendered in {time.time() - t0:.2f}s")
            return self._frame

    def render_png(self) -> bytes:
        from .cli import png_bytes
        from .ops.raymarch import to_u8

        return png_bytes(to_u8(torch.from_numpy(self.render())).numpy())

    def orbit(self, da: float, db: float) -> None:
        # Same drag semantics as the reference's motion handler
        # (DrawPane.cpp:561-589 via rotateAroundVector on the frame triple).
        # Camera mutation takes the render lock so an in-flight render can't
        # mix poses or cache a stale frame past the invalidation.
        with self._render_lock:
            self.camera.orbit(da, db)
            self._frame = None

    def zoom(self, dz: float) -> None:
        with self._render_lock:
            self.camera.zoom(dz)
            self._frame = None

    def reset_camera(self) -> None:
        with self._render_lock:
            self.camera = Camera.initial()
            self._frame = None

    # -- export --
    def start_export(
        self,
        stl_path: str,
        ply_path: Optional[str] = None,
        strategy: str = "auto",
        grid_level: Optional[int] = None,
    ) -> bool:
        """Kick off export on a worker thread (the reference's OnExport
        spawns a worker + a monitor thread, DesignCSG.cpp:839-851); progress
        is polled via :attr:`export_status`."""
        if self.scene is None:
            raise RuntimeError("no scene loaded — run a design first")
        with self._lock:  # atomic check-then-start (concurrent POSTs)
            if self._export_active:
                return False
            self._export_active = True

        status = {"state": "running", "stage": "", "fraction": 0.0, "t0": time.time()}
        self.export_status = status
        # Capture the scene now: a Run during export must not swap the mesh
        # being extracted mid-flight.
        scene = self.scene

        def progress(stage, frac):
            status["stage"] = stage
            status["fraction"] = float(frac)

        def worker():
            from .compiler import ExportConfig
            from .export.pipeline import export_mesh

            config = scene.export_config
            if grid_level is not None:
                import dataclasses

                config = dataclasses.replace(
                    config or ExportConfig(), grid_level=grid_level
                )
            try:
                mesh, report = export_mesh(
                    scene,
                    config,
                    stl_path=stl_path,
                    ply_path=ply_path,
                    progress=progress,
                    strategy=strategy,
                    device=self.device,
                )
            except Exception:
                status["state"] = "failed"
                status["error"] = traceback.format_exc()
                self.log(status["error"])
                return
            finally:
                with self._lock:
                    self._export_active = False
            status.update(
                state="done",
                triangles=int(report.num_triangles),
                vertices=int(report.num_vertices),
                seconds=time.time() - status["t0"],
                stage_seconds={k: round(v, 3) for k, v in report.stage_seconds.items()},
            )
            self.log(
                f"exported {report.num_triangles} triangles to {stl_path} "
                f"in {status['seconds']:.1f}s"
            )

        self._export_thread = threading.Thread(target=worker, daemon=True)
        self._export_thread.start()
        return True


# --------------------------------------------------------------------------
# HTTP surface


def _page(title: str, token: str = "") -> str:
    return PAGE_HTML.replace("__TITLE__", title).replace("__TOKEN__", token)


PAGE_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body { margin:0; font:13px/1.4 system-ui, sans-serif; background:#14161a; color:#d7dae0;
        display:grid; grid-template-columns: 1fr 660px; grid-template-rows: auto 1fr 180px;
        height:100vh; }
 #bar { grid-column:1/3; padding:6px 10px; background:#1d2026; display:flex; gap:6px;
        align-items:center; border-bottom:1px solid #2a2e36; }
 button { background:#2d3440; color:#d7dae0; border:1px solid #3a4250; border-radius:4px;
          padding:4px 10px; cursor:pointer; }
 button:hover { background:#3a4250; }
 select, input[type=text] { background:#22262e; color:#d7dae0; border:1px solid #3a4250;
          border-radius:4px; padding:4px; }
 #editorwrap { display:flex; flex-direction:column; min-width:0; }
 #tabs { display:flex; gap:2px; padding:4px 8px 0; }
 .tab { padding:4px 12px; background:#1d2026; border-radius:4px 4px 0 0; cursor:pointer; }
 .tab.active { background:#22262e; color:#fff; }
 /* Editor = transparent textarea stacked on a highlighted <pre> twin
    (identical font metrics), the CDN-free equivalent of the reference
    shell's wxStyledTextCtrl Python lexer (DesignCSG.cpp:403-420). */
 #edstack { flex:1; position:relative; min-height:0; background:#22262e; }
 #edstack textarea, #edstack pre { position:absolute; inset:0; margin:0;
            border:none; outline:none; overflow:auto;
            font:13px/1.5 ui-monospace, monospace; padding:10px;
            white-space:pre; tab-size:4; }
 textarea { background:transparent; color:transparent; caret-color:#e8eaf0;
            resize:none; z-index:2; }
 #hl { color:#e8eaf0; z-index:1; pointer-events:none; }
 #hl .k { color:#6fb3ff; } #hl .s { color:#a5c261; } #hl .c { color:#7d8799; }
 #hl .n { color:#d19a66; } #hl .d { color:#c678dd; } #hl .f { color:#e5c07b; }
 #view { display:flex; flex-direction:column; align-items:center; padding:10px;
         border-left:1px solid #2a2e36; }
 #viewport { width:640px; height:480px; background:#000; cursor:grab;
             image-rendering:pixelated; user-select:none; }
 #status { padding:6px; color:#8b93a3; }
 #console { grid-column:1/3; background:#101216; color:#9fd89f; overflow-y:auto;
            font:12px/1.4 ui-monospace, monospace; padding:8px; margin:0;
            border-top:1px solid #2a2e36; white-space:pre-wrap; }
</style></head><body>
<div id="bar">
 <select id="designs"></select>
 <button onclick="openDesign()">Open</button>
 <input type="text" id="newname" placeholder="new design name" size="14">
 <button onclick="newDesign()">New</button>
 <button onclick="save()">Save</button>
 <button onclick="saveAs()">Save As</button>
 <button onclick="del()">Delete</button>
 <span style="flex:1"></span>
 <button onclick="run()" style="background:#2f5e33">Run ▶</button>
 <button onclick="doExport()">Export STL</button>
 <button onclick="api('/api/camera/reset',{}).then(refresh)">Reset view</button>
 <label style="color:#8b93a3"><input type="checkbox" id="exact"
  onchange="api('/api/render_mode',{exact:this.checked}).then(refresh)">
  exact march</label>
</div>
<div id="editorwrap">
 <div id="tabs">
  <div class="tab active" id="tab-design" onclick="setTab('design')">design</div>
  <div class="tab" id="tab-library" onclick="setTab('library')">designlibrary.py</div>
 </div>
 <div id="edstack">
  <pre id="hl" aria-hidden="true"><code id="hlcode"></code></pre>
  <textarea id="editor" spellcheck="false"></textarea>
 </div>
</div>
<div id="view">
 <img id="viewport" draggable="false" alt="viewport">
 <div id="status">no scene — open a design and press Run</div>
</div>
<pre id="console"></pre>
<script>
let current = null, tab = 'design', texts = {design:'', library:''}, libLoaded = false;
const $ = id => document.getElementById(id);
// Python highlighter: one alternation pass, escape-as-emitted.  Order
// matters (comments/strings before keywords).  A regex LITERAL, not
// new RegExp(string): string escapes would decode once as JS string
// syntax and turn \b into a backspace character.  Groups: 1 comment,
// 2 string, 3 decorator, 4 keyword, 5 number.
const PY_RE = /(#[^\\n]*)|("{3}[\\s\\S]*?"{3}|'{3}[\\s\\S]*?'{3}|"(?:[^"\\\\\\n]|\\\\.)*"|'(?:[^'\\\\\\n]|\\\\.)*')|(^[ \\t]*@[\\w.]+)|\\b(def|class|return|if|elif|else|for|while|import|from|as|with|lambda|try|except|finally|raise|pass|break|continue|in|is|not|and|or|None|True|False|global|nonlocal|yield|assert|del|async|await)\\b|\\b(\\d+\\.?\\d*(?:[eE][+-]?\\d+)?)\\b/gm;
const esc = s => s.replace(/&/g,'&amp;').replace(/</g,'&lt;').replace(/>/g,'&gt;');
function highlight(src){
  let out = '', last = 0, m;
  PY_RE.lastIndex = 0;
  while ((m = PY_RE.exec(src)) !== null){
    out += esc(src.slice(last, m.index));
    const cls = m[1]!==undefined?'c':m[2]!==undefined?'s':m[3]!==undefined?'d':
                m[4]!==undefined?'k':'n';
    out += '<span class="'+cls+'">'+esc(m[0])+'</span>';
    last = m.index + m[0].length;
  }
  // trailing newline needs a filler so the <pre> keeps the last line's height
  return out + esc(src.slice(last)) + '\\n';
}
function rehl(){ $('hlcode').innerHTML = highlight($('editor').value); syncScroll(); }
function syncScroll(){ const t=$('editor'), h=$('hl');
  h.scrollTop=t.scrollTop; h.scrollLeft=t.scrollLeft; }
function setEditor(v){ $('editor').value = v; rehl(); }
function setTab(t){ texts[tab] = $('editor').value; tab = t;
  $('tab-design').classList.toggle('active', t==='design');
  $('tab-library').classList.toggle('active', t==='library');
  setEditor(texts[t]); }
const TOKEN = '__TOKEN__';
async function api(path, body){
  const r = await fetch(path, body===undefined?{}:{method:'POST',
    headers:{'Content-Type':'application/json', 'X-Studio-Token':TOKEN},
    body:JSON.stringify(body)});
  return r.json(); }
async function refreshList(){
  const d = await api('/api/designs');
  const sel = $('designs'); sel.innerHTML='';
  d.designs.forEach(n=>{const o=document.createElement('option');o.value=n;
    o.textContent=n; sel.appendChild(o);});
  if (d.last) sel.value = d.last; }
async function loadLibrary(){
  const l = await api('/api/design?name=designlibrary');
  texts.library = l.text; libLoaded = true;
  if (tab==='library') setEditor(texts.library); }
async function openDesign(){
  current = $('designs').value; if(!current) return;
  const d = await api('/api/design?name='+encodeURIComponent(current));
  texts.design = d.text; setEditor(texts[tab]);
  status(current + ' opened'); }
async function newDesign(){
  const n = $('newname').value.trim(); if(!n) return;
  await api('/api/new', {name:n}); await refreshList();
  $('designs').value = n; openDesign(); }
async function save(){
  texts[tab] = $('editor').value;
  if (current) await api('/api/save', {name:current, text:texts.design});
  // Never overwrite the library with text we never loaded.
  if (libLoaded) await api('/api/save', {name:'designlibrary', text:texts.library});
  status('saved'); }
async function saveAs(){
  const n = $('newname').value.trim(); if(!n) return;
  texts[tab] = $('editor').value;
  await api('/api/save', {name:n, text:texts.design});
  current = n; await refreshList(); $('designs').value = n; status('saved as '+n); }
async function del(){
  const n = $('designs').value; if(!n) return;
  await api('/api/delete', {name:n}); current=null; await refreshList(); }
async function run(){
  texts[tab] = $('editor').value; await save();
  status('running…');
  const r = await api('/api/run',
    current ? {name: current} : {text: texts.design});
  status(r.ok ? 'scene loaded' : 'script error — see console');
  await refresh(); }
async function refresh(){
  $('viewport').src = '/render.png?t=' + Date.now();
  const c = await api('/api/console'); $('console').textContent = c.lines.join('\\n');
  $('console').scrollTop = $('console').scrollHeight; }
async function doExport(){
  const r = await api('/api/export', {});
  if (!r.started){ status('export already running'); return; }
  const poll = setInterval(async ()=>{
    const s = await api('/api/export');
    if (s.state==='running') status('export: '+s.stage+' '+Math.round(s.fraction*100)+'%');
    else { clearInterval(poll); status('export '+s.state); refresh(); }
  }, 500); }
function status(t){ $('status').textContent = t; }
$('editor').addEventListener('input', rehl);
$('editor').addEventListener('scroll', syncScroll);
rehl();
let drag = null;
$('viewport').addEventListener('mousedown', e=>{ drag=[e.clientX,e.clientY]; });
window.addEventListener('mouseup', async e=>{
  if(!drag) return; const dx=e.clientX-drag[0], dy=e.clientY-drag[1]; drag=null;
  if (dx||dy){ await api('/api/camera/orbit', {da:-dx*0.01, db:dy*0.01}); refresh(); } });
$('viewport').addEventListener('wheel', async e=>{
  e.preventDefault(); await api('/api/camera/zoom', {dz: e.deltaY>0?-1:1}); refresh(); });
document.addEventListener('keydown', e=>{
  if ((e.ctrlKey||e.metaKey) && e.key==='Enter'){ e.preventDefault(); run(); }
  if ((e.ctrlKey||e.metaKey) && e.key==='s'){ e.preventDefault(); save(); } });
refreshList().then(()=>{ loadLibrary(); if($('designs').value){ openDesign(); } });
</script></body></html>
"""


class StudioHandler(BaseHTTPRequestHandler):
    # Set by StudioServer
    session: StudioSession = None

    def log_message(self, fmt, *args):  # silence default stderr chatter
        pass

    def _send(self, code: int, body: bytes, ctype: str = "application/json"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj, code: int = 200):
        self._send(code, json.dumps(obj).encode())

    def _body(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        if not n:
            return {}
        return json.loads(self.rfile.read(n).decode())

    class _Reject(Exception):
        def __init__(self, code: int, message: str):
            self.code, self.message = code, message

    def _check_post(self) -> None:
        """Drive-by/CSRF defenses for state-changing requests: a cross-origin
        'simple' POST (e.g. text/plain from any web page) must never reach an
        endpoint that execs code or writes files.  Three independent gates:
        JSON content type (simple requests can't send it... they can — so it
        is not sufficient alone), an Origin/Host match, and a per-session
        random token that only the served page knows (custom headers force a
        CORS preflight, which this server never grants)."""
        ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
        if self.headers.get("Content-Length") and ctype != "application/json":
            raise self._Reject(415, "Content-Type must be application/json")
        origin = self.headers.get("Origin")
        host = self.headers.get("Host")
        if origin is not None:
            from urllib.parse import urlparse

            if urlparse(origin).netloc != host:
                raise self._Reject(403, "cross-origin request rejected")
        token = self.headers.get("X-Studio-Token") or ""
        # bytes comparison: compare_digest raises TypeError on non-ASCII str
        # (which would surface as a 500 + traceback instead of a 403)
        if not secrets.compare_digest(
            token.encode("utf-8", "replace"), self.session.token.encode()
        ):
            raise self._Reject(403, "missing or invalid X-Studio-Token")

    def do_GET(self):
        try:
            self._route(self.path.split("?")[0], {}, "GET")
        except self._Reject as r:
            self._json({"error": r.message}, r.code)
        except Exception:
            self._json({"error": traceback.format_exc()}, 500)

    def do_POST(self):
        try:
            self._check_post()
            self._route(self.path.split("?")[0], self._body(), "POST")
        except self._Reject as r:
            self._json({"error": r.message}, r.code)
        except json.JSONDecodeError:
            self._json({"error": "request body is not valid JSON"}, 400)
        except Exception:
            self._json({"error": traceback.format_exc()}, 500)

    @staticmethod
    def _require(body: dict, key: str):
        try:
            return body[key]
        except KeyError:
            raise StudioHandler._Reject(400, f"missing required field {key!r}")

    def _query(self) -> dict:
        from urllib.parse import parse_qs, urlparse

        q = parse_qs(urlparse(self.path).query)
        return {k: v[0] for k, v in q.items()}

    #: The ONLY routes reachable via GET — everything else is POST-only so
    #: the CSRF gate (which runs on POST) covers mutating routes by
    #: DEFAULT: a newly added route cannot accidentally fail open to a
    #: cross-origin <img>/<script> GET.
    _GET_OK = frozenset(
        {"/", "/render.png", "/api/designs", "/api/design", "/api/console",
         "/api/export"}
    )

    def _route(self, path: str, body: dict, method: str = "GET"):
        if method == "GET" and path not in self._GET_OK:
            self._json({"error": f"{path} requires POST"}, 405)
            return
        s = self.session
        ws = s.workspace
        if path == "/":
            self._send(
                200,
                _page("designcsg_tpu_torch studio", s.token).encode(),
                "text/html",
            )
        elif path == "/api/designs":
            self._json({"designs": ws.list_designs(), "last": ws.get_last()})
        elif path == "/api/design":
            name = self._query().get("name", "")
            if name == "designlibrary":
                name = LIBRARY_BASENAME
            self._json({"text": ws.read(name)})
        elif path == "/api/new":
            ws.new(self._require(body, "name"))
            self._json({"ok": True})
        elif path == "/api/save":
            name = self._require(body, "name")
            if name == "designlibrary":
                name = LIBRARY_BASENAME
            ws.write(name, self._require(body, "text"))
            self._json({"ok": True})
        elif path == "/api/delete":
            ws.delete(self._require(body, "name"))
            self._json({"ok": True})
        elif path == "/api/run":
            if body.get("name"):
                ok = s.run_design(body["name"])
            elif body.get("text"):
                ok = s.run_text(body["text"])
            else:
                s.log("run: no design open and no script text sent")
                self._json({"ok": False, "error": "nothing to run"})
                return
            self._json({"ok": ok})
        elif path == "/api/console":
            with s._lock:
                lines = list(s.console)
            self._json({"lines": lines})
        elif path == "/render.png":
            if s.scene is None:
                self._json({"error": "no scene"}, 404)
            else:
                self._send(200, s.render_png(), "image/png")
        elif path == "/api/camera/orbit":
            s.orbit(float(body.get("da", 0.0)), float(body.get("db", 0.0)))
            self._json({"ok": True})
        elif path == "/api/camera/zoom":
            s.zoom(float(body.get("dz", 0.0)))
            self._json({"ok": True})
        elif path == "/api/camera/reset":
            s.reset_camera()
            self._json({"ok": True})
        elif path == "/api/render_mode":
            # POST-only (CSRF-gated): {"exact": true} switches the viewport
            # to exact k1 semantics; false restores the fast march.
            s.set_render_mode(bool(body.get("exact")))
            self._json({"ok": True, "exact": s.exact_render})
        elif path == "/api/export":
            # POST starts an export; GET polls its status.
            if method == "POST":
                name = ws.get_last() or "design"
                stl = body.get("stl") or os.path.join(
                    ws.root, "Exports", f"{name}.stl"
                )
                if os.path.dirname(stl):
                    os.makedirs(os.path.dirname(stl), exist_ok=True)
                started = s.start_export(
                    stl,
                    ply_path=body.get("ply"),
                    strategy=body.get("strategy", "auto"),
                    grid_level=body.get("grid_level"),
                )
                self._json({"started": started, "stl": stl})
            else:
                self._json(s.export_status)
        else:
            self._json({"error": f"no route {path}"}, 404)


class StudioServer(ThreadingHTTPServer):
    """The studio's HTTP server; ``.session`` and ``.workspace`` are live."""

    daemon_threads = True

    def __init__(self, workspace_root: str, port: int = 0, host: str = "127.0.0.1",
                 width: int = 640, height: int = 480, device=None):
        self.workspace = Workspace(workspace_root)
        self.session = StudioSession(
            self.workspace, width=width, height=height, device=device
        )
        handler = type("Handler", (StudioHandler,), {"session": self.session})
        super().__init__((host, port), handler)

    @property
    def url(self) -> str:
        return f"http://{self.server_address[0]}:{self.server_address[1]}/"

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t


def serve(workspace_root: str, port: int = 8642, **kwargs) -> None:
    """Run the studio until interrupted (CLI: ``cli studio <workspace>``)."""
    server = StudioServer(workspace_root, port=port, **kwargs)
    last = server.workspace.get_last()
    if last:
        server.session.run_design(last)
    print(f"designcsg_tpu_torch studio at {server.url} (workspace {server.workspace.root}, "
          f"{server.session.device})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
