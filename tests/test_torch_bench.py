"""The port's benchmark (designcsg_tpu_torch/bench.py) on the CPU: its cells
at tiny sizes against the JAX package's functions that the root bench.py
calls, its payload and configurations against bench.py's own literals, its
command's wiring and its labels.

On CPU tensors every wrapper takes its plain version, so the cells run here
as a user's ``--device cpu`` call runs them; on the card the same cells run
the kernels (tests/test_torch_cuda.py, chip_smoke.py).  The cells take the
scene, the configuration and the repetitions, so the tests call them at
32x24 frames, a 2^5 export lattice and 16^3 grid points."""

import ast
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import designs
from designcsg_tpu import native as jnative
from designcsg_tpu.compiler import ExportConfig as JExportConfig
from designcsg_tpu.config import RenderConfig as JRenderConfig
from designcsg_tpu.export.pipeline import export_mesh as j_export_mesh
from designcsg_tpu.ops.interpreter import make_primary_sdf as j_make_primary_sdf
from designcsg_tpu.ops.raymarch import make_renderer as j_make_renderer
from designcsg_tpu.parallel.fit import make_fit_harness as j_make_fit_harness
from designcsg_tpu_torch import bench, cli, native
from designcsg_tpu_torch.camera import Camera
from designcsg_tpu_torch.compiler import ExportConfig
from designcsg_tpu_torch.config import RenderConfig
from designcsg_tpu_torch.designs import get_design
from designcsg_tpu_torch.ops.raymarch import render_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(width=32, height=24)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the suite runs one process per
    worker, and a default-sized thread pool in each oversubscribes the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def scenes():
    return designs.get_design("design1"), get_design("design1")


@pytest.fixture(scope="module")
def bench_py():
    """The root bench.py's syntax tree and text."""
    with open(os.path.join(REPO, "bench.py")) as f:
        text = f.read()
    return ast.parse(text), text


def bench_call(tree, name: str, line: int) -> dict:
    """The literal keywords of bench.py's call of ``name`` at ``line``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == name \
                and node.lineno == line:
            return {k.arg: ast.literal_eval(k.value) for k in node.keywords
                    if isinstance(k.value, ast.Constant)}
    raise AssertionError(f"bench.py:{line} has no {name}(...) call")


@pytest.mark.parametrize("config", [bench.OVERRELAX, bench.EXACT], ids=["overrelax", "exact"])
def test_frame_cell_matches_jax_make_renderer(scenes, config):
    """Design1's over-relaxed and exact cells at 32x24 from a camera orbited
    by a seeded angle: the frame the cell times against JAX's
    ``make_renderer`` at the same config (the renderer's rule,
    tests/test_pallas.py:115-116), and bit for bit the port's
    ``render_scene``."""
    jscene, tscene = scenes
    config = dataclasses.replace(config, **TINY)
    da, db = np.random.default_rng(12).uniform(-0.3, 0.3, 2)
    camera = Camera.initial().orbit(float(da), float(db))
    cell = bench.render_cell(tscene, config, 1, "cpu", camera=camera)
    assert cell["engine"] == "tape" and cell["seconds"] > 0
    assert cell["rays_per_s"] == pytest.approx(32 * 24 / cell["seconds"])
    frame = cell["frame"].numpy()
    assert frame.shape == (24, 32, 3)
    ref = np.asarray(j_make_renderer(jscene, JRenderConfig(**dataclasses.asdict(config)))(
        jscene.arrays, *camera.as_arrays()))
    diff = np.abs(frame - ref)
    assert diff.max() < 1e-3 and (diff > 1e-4).mean() < 0.01
    same = render_scene(tscene, camera=camera, config=config, device="cpu")
    assert torch.equal(cell["frame"], same)


def keyed_faces(mesh):
    """Faces rotated to start at their least vertex index (winding kept),
    rows sorted: equal for two meshes of one triangle set welded by key."""
    f = mesh.faces
    k = np.argmin(f, axis=1)
    rolled = np.stack([f[np.arange(len(f)), (k + i) % 3] for i in range(3)], 1)
    return rolled[np.lexsort(rolled.T[::-1])]


def test_export_cell_matches_jax_export_mesh(scenes, monkeypatch):
    """The Design1 export cell's ``active`` strategy cut to grid level 5 (a
    32^3 box scan in place of 256^3) with its 50 refine steps: JAX's
    ``export_mesh`` at the same config gives the same triangles, vertices
    within 1e-4 (both sides on their numpy welds, so vertices are numbered
    by lattice key).  One trial."""
    jscene, tscene = scenes
    monkeypatch.setattr(bench, "TRIALS", 1)
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(native, "available", lambda: False)
    config = dataclasses.replace(bench.D1_EXPORT, grid_level=5)
    cell = bench.export_cell(tscene, config, 1, "cpu", strategy="active", autodetect_resolution=32)
    mesh, report = cell["mesh"], cell["report"]
    jmesh, jreport = j_export_mesh(jscene, JExportConfig(**dataclasses.asdict(config)),
                                   strategy="active", autodetect_resolution=32)
    assert cell["seconds"] > 0 and report.stats["strategy"] == "active"
    assert report.num_triangles == jreport.num_triangles == mesh.num_faces > 0
    assert mesh.num_vertices == jmesh.vertices.shape[0]
    np.testing.assert_array_equal(keyed_faces(mesh), keyed_faces(jmesh))
    np.testing.assert_allclose(mesh.vertices, np.asarray(jmesh.vertices), rtol=0, atol=1e-4)


def test_fit_cell_first_step_matches_jax(scenes, monkeypatch):
    """The Design1 fit cell at 32x24 (bench.py's fit config, its start):
    the first step's loss within rtol 1e-5 of JAX's harness step (its
    ``loss_fn`` at the start, under ``jax.value_and_grad``), and its
    position gradient within 1e-5.  One trial (the cells' timing rule is
    held by test_time_calls_warms_then_keeps_the_best_trial)."""
    jscene, tscene = scenes
    monkeypatch.setattr(bench, "TRIALS", 1)
    config = dataclasses.replace(bench.fit_config("exact"), **TINY)
    cell = bench.fit_cell(tscene, config, 1, "cpu")
    assert cell["seconds"] > 0
    jh = j_make_fit_harness(jscene, JRenderConfig(**dataclasses.asdict(config)),
                            optimizer=optax.adam(1e-2), use_mesh=False)
    cam = Camera.initial().as_arrays()
    target = jh.render_target(jscene.arrays, *cam)
    start = np.asarray(jscene.arrays.position).copy()
    start[1:, 0] += 0.05
    # The loss and gradient of JAX's step: its harness's loss_fn at the start.
    loss, grad = jax.value_and_grad(lambda p: jh.loss_fn({"position": p}, target, *cam))(
        jnp.asarray(start))
    assert cell["loss"] > 0
    np.testing.assert_allclose(cell["loss"], float(loss), rtol=1e-5)
    np.testing.assert_allclose(cell["grad"], np.asarray(grad), rtol=0, atol=1e-5)
    assert np.abs(cell["grad"]).max() > 0


def test_time_calls_warms_then_keeps_the_best_trial(monkeypatch):
    """One warm call, then TRIALS trials of ``reps`` calls, each after
    ``reset``: the best trial's seconds over ``reps``, the warm call's
    seconds and value, and the best trial's last value."""
    clock, events = iter([0.0, 7.0, 10.0, 15.0, 20.0, 22.0, 30.0, 36.0]), []
    monkeypatch.setattr(bench.time, "perf_counter", lambda: next(clock))
    n = iter(range(100))
    timing = bench.time_calls(lambda: events.append("call") or next(n), 2, torch.device("cpu"),
                              reset=lambda: events.append("reset"))
    assert events == ["reset", "call"] + ["reset", "call", "call"] * 3
    assert timing == (1.0, 7.0, 0, 4)


def test_grid_cell_matches_jax_sdf(scenes):
    """The grid cell at 16^3 in 2 slabs: its first slab is JAX's SDF at the
    same lattice points (lo -4, cell 8/16) within 1e-5 + 1e-6|ref|."""
    jscene, tscene = scenes
    cell = bench.grid_cell(tscene, 16, 2, "cpu")
    slab = cell["slab"].numpy()
    assert slab.shape == (8, 16, 16) and cell["seconds"] > 0
    assert cell["evals_per_s"] == pytest.approx(16 ** 3 / cell["seconds"])
    z, y, x = np.meshgrid(np.arange(8), np.arange(16), np.arange(16), indexing="ij")
    pts = (np.float32(-4.0) + np.float32(0.5) * np.stack([x, y, z], -1).astype(np.float32))
    ref = np.asarray(j_make_primary_sdf(jscene)(jnp.asarray(pts.reshape(-1, 3)), jscene.arrays))
    ref = ref.reshape(slab.shape)
    assert np.all(np.abs(slab - ref) <= 1e-5 + 1e-6 * np.abs(ref))


@pytest.mark.parametrize("mode", ["overrelax1.6", "hierarchical+overrelax1.6"])
def test_payload_matches_bench_py(bench_py, mode):
    """bench.py's JSON line (bench.py:368-385): its keys, the metric name of
    each mode, ``vs_baseline`` against 640x480 at 30 FPS and the note word
    for word."""
    tree, _ = bench_py
    out = bench.payload(1.2345678e9, mode, 6.54321e8)
    (node,) = [n for n in ast.walk(tree) if isinstance(n, ast.Dict) and n.lineno == 369]
    keys = [ast.literal_eval(k) for k in node.keys]
    assert list(out) == keys + ["exact_k1_rays_per_s"]  # bench.py:383-384 adds the last
    assert out["metric"] == f"design1_sphere_trace_rays_per_s_chip[{mode}]"
    assert out["value"] == 1234567800 and out["unit"] == "rays/s"
    assert out["vs_baseline"] == round(1.2345678e9 / (640 * 480 * 30.0), 2) == 133.96
    assert out["exact_k1_rays_per_s"] == 654321000
    note = ast.literal_eval(node.values[keys.index("baseline_note")])
    assert out["baseline_note"] == note
    assert json.loads(json.dumps(out)) == out


@pytest.mark.parametrize("name,line,port", [
    ("RenderConfig", 79, bench.OVERRELAX),
    ("RenderConfig", 84, bench.HIERARCHICAL),
    ("RenderConfig", 99, bench.EXACT),
    ("ExportConfig", 202, bench.D1_EXPORT),
    ("ExportConfig", 256, bench.LOGO_EXPORT),
    ("RenderConfig", 303, bench.fit_config("twin")),
], ids=["overrelax", "hierarchical", "exact", "design1_export", "logo_export", "fit"])
def test_cell_configs_match_bench_py_literals(bench_py, name, line, port):
    """Each configuration a cell passes is bench.py's literal at its line,
    and the fields both packages have agree (their defaults included)."""
    tree, _ = bench_py
    kwargs = bench_call(tree, name, line)
    if line == 303:
        kwargs["fit_field"] = "twin"  # bench.py passes its loop's field
    assert port == {"RenderConfig": RenderConfig, "ExportConfig": ExportConfig}[name](**kwargs)
    jax_fields = dataclasses.asdict(
        {"RenderConfig": JRenderConfig, "ExportConfig": JExportConfig}[name](**kwargs))
    ours = dataclasses.asdict(port)
    shared = set(ours) & set(jax_fields)
    assert {"width", "height", "grid_level"} & shared
    assert {k: ours[k] for k in shared} == {k: jax_fields[k] for k in shared}


def test_sizes_match_bench_py(bench_py):
    """The fit cells and their steps (bench.py:294-301), the frame and grid
    repetitions and the grid's lattice (bench.py:44-49, 346-366)."""
    tree, text = bench_py
    (loop,) = [n for n in ast.walk(tree) if isinstance(n, ast.For) and n.lineno == 294]
    assert bench.FIT_CELLS == ast.literal_eval(loop.iter)
    assert "reps=20," in text.splitlines()[48] and bench.FRAME_REPS == 20
    assert "fori_loop(0, 8, body" in text.splitlines()[357]
    assert "ge(arrays, lo + acc * 1e-20, cell, i * 64.0, 64, 512)" in text.splitlines()[354]
    assert (bench.GRID_SIZE // bench.GRID_SLABS, bench.GRID_SIZE, bench.GRID_SLABS) == (64, 512, 8)
    assert "[-4.0, -4.0, -4.0]" in text.splitlines()[348] and bench.GRID_HALF == 4.0


def test_cli_bench_reaches_bench_main_with_the_cpu(monkeypatch):
    seen = []
    monkeypatch.setattr(bench, "main", lambda device="cuda": seen.append(device) or {"ok": 1})
    assert cli.main(["bench", "--device", "cpu"]) == {"ok": 1}
    assert seen == ["cpu"]


def test_cli_bench_without_a_card_raises_naming_it(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["bench"])
    assert capsys.readouterr().out == ""


# Every stderr label of bench.py, in its order, with the port's values for the
# fields bench.py formats in (the engine, the export field).
LABELS = [
    "devices:",
    "march (overrelax 1.6):",
    "march (hierarchical + overrelax):",
    "march (exact k1 semantics):",
    "design2 (hierarchical + overrelax):",
    "design2 viewport (exact k1, cuda):",
    "logo viewport (exact k1, cuda):",
    "logo (hierarchical + overrelax):",
    "design1 export 512^3 (active, 50 refine):",
    "design2 adaptive export (own config, octree 6->8 grid 2^9):",
    "logo export (adaptive 5->7 grid 2^7, sdf_field=cuda-baked):",
    "logo export (adaptive 5->7 grid 2^7, sdf_field=tape-exact):",
    "design1 fit step [exact] (640x480 geometric, fwd+bwd+adam):",
    "logo fit step [exact] (640x480 geometric, fwd+bwd+adam):",
    "logo fit step [twin] (640x480 geometric, fwd+bwd+adam):",
    "grid 512^3:",
]


@pytest.mark.parametrize("hierarchical_faster", [False, True])
def test_main_runs_every_cell_in_bench_py_order(monkeypatch, capsys, hierarchical_faster):
    """``main`` with every cell stubbed: bench.py's labels in bench.py's
    order, each once, at bench.py's sizes; the headline takes the faster
    fast mode (bench.py:88-92); the last stdout line is the payload."""
    import designcsg_tpu_torch.designs as tdesigns
    import designcsg_tpu_torch.evaluator as tevaluator

    calls = []
    monkeypatch.setattr(tdesigns, "get_design", lambda name: name)
    monkeypatch.setattr(tevaluator, "BatchEvaluator",
                        lambda scene, device, use_kernels: "cuda-baked" if use_kernels else "tape-exact")

    def render_cell(scene, config, reps, device):
        calls.append(("render", scene, config.march_overrelax, config.march_hierarchical, reps))
        ms = {(1.6, False): 0.3, (1.6, True): 0.25 if hierarchical_faster else 0.5, (1.0, False): 0.45}
        s = ms[(config.march_overrelax, config.march_hierarchical)] * 1e-3
        return dict(seconds=s, warm_seconds=1.0, rays_per_s=config.width * config.height / s,
                    engine="cuda")

    class Report:
        def __init__(self, field):
            self.num_triangles, self.sdf_evals = 1000, 2e6
            self.stage_seconds = {"extract": 1.0}
            self.stats = {"sdf_field": field, "level_triangles": {6: 1}, "open_loops": 0}

    def export_cell(scene, config, reps, device, evaluator="cuda-exact", **kw):
        calls.append(("export", scene, config, reps, kw))
        return dict(seconds=2.0, warm_seconds=3.0, report=Report(evaluator))

    def fit_cell(scene, config, reps, device):
        calls.append(("fit", scene, config.fit_field, reps, (config.width, config.height)))
        return dict(seconds=0.1, warm_seconds=0.2)

    def grid_cell(scene, size, slabs, device):
        calls.append(("grid", scene, size, slabs))
        return dict(seconds=0.02, warm_seconds=0.5, evals_per_s=size ** 3 / 0.02)

    for name, fn in (("render_cell", render_cell), ("export_cell", export_cell),
                     ("fit_cell", fit_cell), ("grid_cell", grid_cell)):
        monkeypatch.setattr(bench, name, fn)
    record = bench.main("cpu")
    captured = capsys.readouterr()
    lines = captured.err.strip().splitlines()
    assert [line for line in lines if not any(line.startswith(label) for label in LABELS)] == []
    assert [next(label for label in LABELS if line.startswith(label)) for line in lines] == LABELS
    assert lines[0] == "devices: cpu"
    assert lines[8] == ("design1 export 512^3 (active, 50 refine): 2.0 s, 1000 tris "
                        "(stages: {'extract': 1.0})")
    assert calls[:7] == [("render", "design1", 1.6, False, 20), ("render", "design1", 1.6, True, 20),
                         ("render", "design1", 1.0, False, 20), ("render", "design2", 1.6, True, 20),
                         ("render", "design2", 1.0, False, 20), ("render", "logo", 1.0, False, 20),
                         ("render", "logo", 1.6, True, 20)]
    assert calls[7] == ("export", "design1", bench.D1_EXPORT, 1, {"strategy": "active"})
    assert calls[8] == ("export", "design2", None, 1, {"strategy": "adaptive"})
    assert calls[9][:4] == calls[10][:4] == ("export", "logo", bench.LOGO_EXPORT, 1)
    assert calls[11:] == [("fit", "design1", "exact", 10, (640, 480)), ("fit", "logo", "exact", 5, (640, 480)),
                          ("fit", "logo", "twin", 10, (640, 480)), ("grid", "design1", 512, 8)]
    out = json.loads(captured.out.strip().splitlines()[-1])
    assert out == record["payload"]
    mode = "hierarchical+overrelax1.6" if hierarchical_faster else "overrelax1.6"
    assert out["metric"] == f"design1_sphere_trace_rays_per_s_chip[{mode}]"
    assert out["value"] == round(640 * 480 / (0.25e-3 if hierarchical_faster else 0.3e-3))
    assert out["exact_k1_rays_per_s"] == round(640 * 480 / 0.45e-3)
    assert record["triangles"] == {"design1_export_active": 1000, "design2_export_adaptive": 1000,
                                   "logo_export_cuda-baked": 1000, "logo_export_tape-exact": 1000}
    assert len(record["seconds"]) == len(record["warm_seconds"]) == 15
