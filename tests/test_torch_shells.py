"""The port's shells on the CPU: observability, the viewer, the studio (driven
headlessly over localhost HTTP) and the CLI's ``watch`` and ``export
--histogram``.  They mirror tests/test_observability.py, tests/test_studio.py
and test_cli.py's orbit, monitor and watch tests of the JAX package, with
design scripts written against the port's API and ``device="cpu"``."""

import http.client
import io
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from designcsg_tpu import observability as jobservability
from designcsg_tpu_torch import cli
from designcsg_tpu_torch.config import RenderConfig
from designcsg_tpu_torch.designs import get_design
from designcsg_tpu_torch.observability import TRACE_FILE, ExportMonitor, StageTimer, profile_trace
from designcsg_tpu_torch.ops.raymarch import render_scene
from designcsg_tpu_torch.studio import (
    LIBRARY_BASENAME,
    NEW_DESIGN_TEMPLATE,
    StudioServer,
    StudioSession,
    Workspace,
)
from designcsg_tpu_torch.viewer import orbit_frames

TINY_DESIGN = """\
import torch
from designcsg_tpu_torch import api
from designcsg_tpu_torch.api import Transform

print("hello from design")
brush = api.sphere_brush()
api.draw(brush, Transform.initial((0.0, 0.0, 0.0), 0.0, 0.0, 0.0, 1.0))
api.setExportConfig(boundingBoxHalfDiameter=1.2, gridLevel=4)
api.commit()
"""


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the suite runs one process per
    worker, and a default-sized thread pool in each oversubscribes the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- observability (tests/test_observability.py) ---------------------------


def test_export_monitor_renders_progress_and_histogram():
    out = io.StringIO()
    mon = ExportMonitor(out=out, min_interval=0.0)
    mon.attach_stats({"level_triangles": {5: 120, 6: 40, 7: 640}})
    mon("EXTRACTING_SURFACE", 0.5)
    mon("EXTRACTING_SURFACE", 1.0)
    text = out.getvalue()
    assert "EXTRACTING_SURFACE" in text
    assert "800 tris" in text  # live triangle total from the telemetry dict
    assert "rss" in text and "MB" in text
    hist = mon.render_histogram()
    assert "level" in hist
    for level, count in [(5, 120), (6, 40), (7, 640)]:
        assert str(level) in hist and str(count) in hist
    hist2 = mon.render_histogram({"slab_triangles": {0: 10, 32: 30}})
    assert "slab z0" in hist2 and "30" in hist2


@pytest.mark.parametrize("stats", [
    {"level_triangles": {6: 6878, 7: 33273, 8: 159137}},
    {"slab_triangles": {0: 10, 32: 30, 64: 0}},
    {"strategy": "dense"},
])
def test_histogram_text_equals_jax(stats):
    assert ExportMonitor().render_histogram(stats) == jobservability.ExportMonitor().render_histogram(stats)


def test_stage_timer_report():
    timer = StageTimer()
    with timer.stage("a"):
        pass
    with timer.stage("b"):
        pass
    rep = timer.report()
    assert "a" in rep and "b" in rep and "total" in rep


def test_profile_trace_writes_trace(tmp_path):
    """A Chrome trace of the profiled block in ``<log_dir>/trace.json``,
    naming the operations that ran (on the card, also the kernels:
    chip_smoke.py checks the renderer kernel's name in it)."""
    log_dir = str(tmp_path / "trace")
    with profile_trace(log_dir):
        render_scene(get_design("design1"), config=RenderConfig(width=16, height=12, max_steps=16),
                     device="cpu")
    with open(os.path.join(log_dir, TRACE_FILE)) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)


def test_interactive_viewer_headless():
    """Drive the interactive viewer without a display: synthetic drag and
    scroll events orbit and zoom the camera and update the image."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg", force=True)
    from designcsg_tpu_torch.viewer import interactive

    scene = get_design("design1")
    session = interactive(scene, config=RenderConfig(width=64, height=48, max_steps=48),
                          device="cpu", show=False)
    img0 = np.asarray(session.image.get_array(), dtype=np.float64).copy()
    fwd0 = np.asarray(session.camera.forward).copy()
    zoom0 = float(session.camera.position[2])

    class Ev:
        def __init__(self, x, y, step=0):
            self.x, self.y, self.step = x, y, step

    session.on_press(Ev(100, 100))
    session.on_move(Ev(160, 130))
    session.on_release(Ev(160, 130))
    assert not np.allclose(np.asarray(session.camera.forward), fwd0)
    assert not np.array_equal(np.asarray(session.image.get_array(), dtype=np.float64), img0)
    session.on_scroll(Ev(0, 0, step=1))
    assert float(session.camera.position[2]) != zoom0

    import matplotlib.pyplot as plt

    plt.close(session.fig)


# -- viewer and CLI (tests/test_cli.py) -------------------------------------


def test_orbit_frames():
    """Frames of an orbit, each the frame render_scene gives from the same
    camera."""
    from designcsg_tpu_torch.camera import Camera

    scene = get_design("design1")
    config = RenderConfig(width=64, height=48, max_steps=64)
    frames = orbit_frames(scene, n_frames=3, config=config, device="cpu")
    assert len(frames) == 3
    assert np.abs(frames[0] - frames[1]).max() > 1e-3  # the camera moved
    cam = Camera.initial()
    cam.orbit(2 * np.pi / 3, 0.0)
    np.testing.assert_array_equal(
        frames[1], render_scene(scene, camera=cam, config=config, device="cpu").numpy())


def test_orbit_animation_writes_a_gif(tmp_path):
    pytest.importorskip("PIL")
    from designcsg_tpu_torch.viewer import orbit_animation

    path = orbit_animation(get_design("design1"), str(tmp_path / "orbit.gif"), n_frames=2,
                           config=RenderConfig(width=16, height=12, max_steps=16), device="cpu")
    assert open(path, "rb").read(6) in (b"GIF87a", b"GIF89a")


def test_stage_timer_and_monitor():
    timer = StageTimer()
    with timer.stage("a"):
        pass
    with timer.stage("b"):
        pass
    report = timer.report()
    assert "a" in report and "total" in report

    buf = io.StringIO()
    monitor = ExportMonitor(out=buf, min_interval=0.0)
    monitor("EXTRACTING_SURFACE", 0.5)
    monitor("EXTRACTING_SURFACE", 1.0)
    assert "EXTRACTING_SURFACE" in buf.getvalue()
    assert "100.0%" in buf.getvalue()


def test_watch_rerenders_on_change(tmp_path, capsys):
    """The edit-run loop: watch re-renders when the script changes and
    survives script errors (the reference's File->Run + log.txt workflow)."""
    script = tmp_path / "d.py"
    good = (
        "from designcsg_tpu_torch import api\n"
        "import numpy as np\n"
        "api.draw(api.sphere_brush(), api.Transform.initial(\n"
        "    position=[0,0,0], yaw=0, pitch=0, roll=0, scale=np.array([1.0]*3)))\n"
    )
    script.write_text(good)
    out = tmp_path / "w.png"

    def mutate():
        # Wait for the first render, then a broken edit, then a fix.
        deadline = time.time() + 120
        while not out.exists() and time.time() < deadline:
            time.sleep(0.2)
        script.write_text("raise RuntimeError('syntax-ish failure')\n")
        os.utime(script)
        time.sleep(1.0)
        script.write_text(good)
        os.utime(script)

    t = threading.Thread(target=mutate)
    t.start()
    cli.main(["watch", str(script), "-o", str(out), "--width", "64", "--height", "48",
              "--poll", "0.2", "--max-renders", "3", "--device", "cpu"])
    t.join()
    printed = capsys.readouterr().out
    assert out.exists() and cli.read_png(str(out)).shape == (48, 64, 3)
    assert "design error: RuntimeError: syntax-ish failure" in printed
    assert printed.count("rendered 64x48") == 2


def test_export_histogram(tmp_path, capsys):
    """``export --histogram`` prints the per-slab or per-level triangle
    histogram after the export (cli.py:196-201 of the JAX package)."""
    script, stl = tmp_path / "ball.py", str(tmp_path / "ball.stl")
    script.write_text(TINY_DESIGN)
    cli.main(["export", str(script), "--stl", stl, "--strategy", "active", "--histogram",
              "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "slab z0   triangles" in printed and "#" in printed
    count = int(printed.split("exported ")[1].split()[0])
    rows = [line.split() for line in printed.splitlines() if line.strip()[:1].isdigit()]
    assert sum(int(r[1]) for r in rows if len(r) >= 2) == count


# -- studio (tests/test_studio.py) ------------------------------------------


class Client:
    def __init__(self, server):
        host, port = server.server_address
        token = server.session.token

        def call(method, path, body=None, headers=None):
            conn = http.client.HTTPConnection(host, port, timeout=120)
            payload = json.dumps(body).encode() if body is not None else None
            if headers is None:
                headers = {"Content-Type": "application/json", "X-Studio-Token": token}
            conn.request(method, path, body=payload, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            conn.close()
            return resp.status, resp.getheader("Content-Type"), data

        self.call = call

    def get(self, path):
        return self.call("GET", path)

    def json(self, method, path, body=None):
        status, _, data = self.call(method, path, body)
        return status, json.loads(data)


@pytest.fixture()
def server(tmp_path):
    srv = StudioServer(str(tmp_path / "ws"), port=0, width=64, height=48, device="cpu")
    srv.start_background()
    yield srv
    srv.shutdown()
    srv.server_close()


def _wait_export(c):
    deadline = time.time() + 120
    while time.time() < deadline:
        _, s = c.json("GET", "/api/export")
        if s["state"] in ("done", "failed"):
            return s
        time.sleep(0.2)
    return s


def test_workspace_file_management(tmp_path):
    ws = Workspace(str(tmp_path / "ws"))
    assert os.path.exists(os.path.join(ws.root, LIBRARY_BASENAME))
    assert ws.list_designs() == []
    ws.new("mydesign")
    assert ws.read("mydesign") == NEW_DESIGN_TEMPLATE
    with pytest.raises(FileExistsError):
        ws.new("mydesign")
    ws.write("mydesign", "# edited\n")
    assert ws.read("mydesign") == "# edited\n"
    ws.set_last("mydesign")
    assert ws.get_last() == "mydesign"
    ws.delete("mydesign")
    assert ws.list_designs() == []
    assert ws.get_last() is None  # stale last-open filtered
    with pytest.raises(ValueError):
        ws.delete(LIBRARY_BASENAME)
    with pytest.raises(ValueError):
        ws.read("../escape")


def test_studio_end_to_end(server):
    c = Client(server)
    status, ctype, page = c.get("/")
    assert status == 200 and "text/html" in ctype and b"viewport" in page

    status, r = c.json("POST", "/api/new", {"name": "ball"})
    assert status == 200 and r["ok"]
    status, r = c.json("GET", "/api/design?name=ball")
    assert r["text"] == NEW_DESIGN_TEMPLATE
    # The template itself runs, on the port's API.
    _, r = c.json("POST", "/api/run", {"name": "ball"})
    assert r["ok"] and server.session.engine == "tape"
    c.json("POST", "/api/save", {"name": "ball", "text": TINY_DESIGN})

    status, r = c.json("POST", "/api/run", {"name": "ball"})
    assert r["ok"]
    _, r = c.json("GET", "/api/console")
    assert any("hello from design" in line for line in r["lines"])
    status, ctype, png = c.get("/render.png")
    assert status == 200 and ctype == "image/png" and png[:4] == b"\x89PNG"

    _, r = c.json("GET", "/api/designs")
    assert r["designs"] == ["ball"] and r["last"] == "ball"

    before = cli.decode_png(png)
    assert before.shape == (48, 64, 3)
    c.json("POST", "/api/camera/orbit", {"da": 0.6, "db": -0.3})
    c.json("POST", "/api/camera/zoom", {"dz": 2})
    _, _, png2 = c.get("/render.png")
    after = cli.decode_png(png2)
    assert np.abs(before.astype(int) - after.astype(int)).max() > 0
    c.json("POST", "/api/camera/reset")
    _, _, png3 = c.get("/render.png")
    assert np.array_equal(cli.decode_png(png3), before)


def test_studio_script_error_survives(server):
    c = Client(server)
    c.json("POST", "/api/save", {"name": "bad", "text": "raise ValueError('boom')\n"})
    status, r = c.json("POST", "/api/run", {"name": "bad"})
    assert status == 200 and not r["ok"]
    _, r = c.json("GET", "/api/console")
    assert any("boom" in line for line in r["lines"])
    c.json("POST", "/api/save", {"name": "good", "text": TINY_DESIGN})
    _, r = c.json("POST", "/api/run", {"name": "good"})
    assert r["ok"]


def test_studio_export_monitored(server, tmp_path):
    c = Client(server)
    c.json("POST", "/api/save", {"name": "ball", "text": TINY_DESIGN})
    _, r = c.json("POST", "/api/run", {"name": "ball"})
    assert r["ok"]
    stl = str(tmp_path / "out.stl")
    _, r = c.json("POST", "/api/export", {"stl": stl, "grid_level": 4})
    assert r["started"]
    s = _wait_export(c)
    assert s["state"] == "done", s.get("error")
    assert s["triangles"] > 0 and os.path.getsize(stl) > 84
    assert "stage_seconds" in s and s["fraction"] == 1.0


def test_studio_designlibrary_importable(server):
    c = Client(server)
    c.json("POST", "/api/save", {"name": "designlibrary", "text": "RADIUS = 0.25\n"})
    design = (
        "import torch\n"
        "import designlibrary\n"
        "from designcsg_tpu_torch import api\n"
        "from designcsg_tpu_torch.api import Transform\n"
        "def ball(v, ctx):\n"
        "    return torch.linalg.vector_norm(v, dim=-1) - designlibrary.RADIUS\n"
        "b = api.define_brush(ball, name='ball')\n"
        "api.draw(b, Transform.initial((0,0,0),0.0,0.0,0.0,1.0))\n"
        "api.commit()\n"
    )
    c.json("POST", "/api/save", {"name": "libuser", "text": design})
    _, r = c.json("POST", "/api/run", {"name": "libuser"})
    assert r["ok"]


def test_studio_export_ui_contract(server):
    """The browser UI posts an empty JSON body to start an export and GETs
    the same path to poll."""
    c = Client(server)
    c.json("POST", "/api/save", {"name": "ball", "text": TINY_DESIGN})
    _, r = c.json("POST", "/api/run", {"name": "ball"})
    assert r["ok"]
    _, r = c.json("POST", "/api/export", {"grid_level": 3})
    assert r["started"] and r["stl"].endswith("ball.stl")
    s = _wait_export(c)
    assert s["state"] == "done", s.get("error")
    assert os.path.exists(r["stl"])


def test_studio_exact_render_toggle(server):
    """The viewport's exact/fast toggle: the route is POST-only, and the
    exact mode is k1's exact march.  On the CPU both modes march exactly;
    the card's fast mode is chip_smoke.py's to check."""
    client = Client(server)
    session = server.session
    assert session.exact_render is False
    assert float(session.config.march_overrelax) == 1.0  # the CPU renders exact
    status, body = client.json("POST", "/api/render_mode", {"exact": True})
    assert status == 200 and body["exact"] is True
    assert session.exact_render is True
    assert float(session.config.march_overrelax) == 1.0
    assert not session.config.march_hierarchical
    status, _ = client.json("GET", "/api/render_mode")
    assert status == 405
    status, _, page = client.get("/")
    assert b"exact march" in page
    status, body = client.json("POST", "/api/render_mode", {"exact": False})
    assert status == 200 and session.exact_render is False


def test_studio_run_nothing(server):
    c = Client(server)
    _, r = c.json("POST", "/api/run", {})
    assert r["ok"] is False and "error" in r


def test_studio_csrf_defenses(server):
    c = Client(server)
    status, _, _ = c.call("POST", "/api/run", {"text": "open('/tmp/pwned','w')"},
                          headers={"Content-Type": "text/plain"})
    assert status in (403, 415)
    status, _, _ = c.call("POST", "/api/run", {"text": "pass"},
                          headers={"Content-Type": "application/json"})
    assert status == 403
    status, _, _ = c.call("POST", "/api/new", {"name": "x"}, headers={
        "Content-Type": "application/json", "X-Studio-Token": server.session.token,
        "Origin": "http://evil.example"})
    assert status == 403
    status, ctype, page = c.get("/")
    assert status == 200 and server.session.token in page.decode()


def test_studio_bad_request_is_400(server):
    c = Client(server)
    status, r = c.json("POST", "/api/new", {})
    assert status == 400 and "name" in r["error"]
    status, r = c.json("POST", "/api/save", {"name": "x"})
    assert status == 400 and "text" in r["error"]


def test_studio_mutating_routes_require_post(server):
    c = Client(server)
    status, _, _ = c.call("GET", "/api/camera/reset")
    assert status == 405
    status, _, _ = c.call("GET", "/api/run")
    assert status == 405


def test_studio_editor_syntax_highlighting(server):
    """The served page's Python highlighter (a regex literal whose syntax JS
    and Python share) classifies comments, strings, decorators, keywords
    and numbers."""
    import re

    status, _, page = Client(server).get("/")
    assert status == 200
    page = page.decode()
    assert 'id="hl"' in page and 'id="hlcode"' in page
    assert "function highlight(" in page
    m = re.search(r"const PY_RE = (/.*/)gm;", page)
    assert m, "highlighter regex literal missing from the served page"
    rx = re.compile(m.group(1)[1:-1], re.M)
    src = 'def f(x):\n    """doc"""\n    # comment\n    return x + 3.5e2 or None\n@deco\nclass A: pass\n'
    kinds = {1: "comment", 2: "string", 3: "deco", 4: "kw", 5: "num"}
    got = {(kinds[mm.lastindex], mm.group(0)) for mm in rx.finditer(src)}
    expect = {("kw", "def"), ("string", '"""doc"""'), ("comment", "# comment"), ("kw", "return"),
              ("num", "3.5e2"), ("kw", "or"), ("kw", "None"), ("deco", "@deco"), ("kw", "class"),
              ("kw", "pass")}
    assert not (expect - got), expect - got


def test_studio_session_device(tmp_path):
    """The session runs on the device it is given; without a card, the
    default ``cuda`` raises rather than rendering on the CPU unasked."""
    session = StudioSession(Workspace(str(tmp_path / "ws")), width=40, height=30, device="cpu")
    assert session.run_text(TINY_DESIGN) and session.render().shape == (30, 40, 3)
    assert session.device.type == "cpu" and session.engine == "tape"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StudioSession(Workspace(str(tmp_path / "ws2")))
