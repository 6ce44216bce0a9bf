"""The port's CLI (``python -m designcsg_tpu_torch.cli``) in process on the
CPU, mirroring tests/test_cli.py: render (also ``--fast``), render by script
path, export at its default strategy against the JAX CLI's, preview against
the JAX package's rasterizer, artifacts against its ``write_artifacts``, and
fit (``bench``: tests/test_torch_bench.py)."""

import os

import numpy as np
import pytest
import torch

from designcsg_tpu_torch import cli
from designcsg_tpu_torch.config import RenderConfig
from designcsg_tpu_torch.parallel.fit import load_checkpoint


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the suite runs one process per
    worker, and a default-sized thread pool in each oversubscribes the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("fast", [False, True])
def test_render_command(tmp_path, fast):
    out = str(tmp_path / "r.png")
    cli.main(["render", "design1", "-o", out, "--width", "64", "--height", "48", "--device", "cpu"]
             + (["--fast"] if fast else []))
    img = cli.read_png(out)
    assert img.shape == (48, 64, 3) and img.dtype == np.uint8
    assert len(np.unique(img.reshape(-1, 3), axis=0)) > 2  # the part, the miss colour, shades


def test_fast_config_matches_the_jax_cli():
    """--fast: omega = 1.6, hierarchical when both sides divide by F
    (designcsg_tpu/cli.py:70-85)."""
    assert cli.fast_config(RenderConfig()).march_hierarchical
    assert cli.fast_config(RenderConfig()).march_overrelax == 1.6
    odd = cli.fast_config(RenderConfig(width=64, height=48))
    assert odd.march_overrelax == 1.6 and not odd.march_hierarchical


def test_render_design_script_by_path(tmp_path):
    script = tmp_path / "mydesign.py"
    script.write_text(
        "import numpy as np\n"
        "from designcsg_tpu_torch import api\n"
        "from designcsg_tpu_torch.api import Transform, draw\n"
        "draw(api.sphere_brush(), Transform.initial(position=[0,0,0], yaw=0,\n"
        "     pitch=0, roll=0, scale=np.array([1.0]*3)))\n"
    )
    out = str(tmp_path / "s.png")
    cli.main(["render", str(script), "-o", out, "--width", "64", "--height", "48", "--device", "cpu"])
    assert cli.read_png(out).shape == (48, 64, 3)


def test_export_command(tmp_path, capsys):
    """``export`` at its default strategy ("auto", as the JAX CLI's) gives
    the JAX CLI's mesh: the same triangle count and the same STL size."""
    from designcsg_tpu import cli as jcli

    stl = str(tmp_path / "d1.stl")
    cli.main(["export", "design1", "--stl", stl, "--grid-level", "4", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "strategy: active" in printed
    jstl = str(tmp_path / "j1.stl")
    jcli.main(["export", "design1", "--stl", jstl, "--grid-level", "4"])
    jprinted = capsys.readouterr().out
    count = int(printed.split("exported ")[1].split()[0])
    assert count > 0 and f"exported {count} triangles" in jprinted
    assert os.path.getsize(stl) == os.path.getsize(jstl) == 84 + 50 * count


def test_preview_command_matches_jax(tmp_path):
    """``preview`` rasterizes an exported mesh to a PNG; the port's numpy
    rasterizer gives the JAX package's image."""
    from designcsg_tpu.export import preview as jpreview
    from designcsg_tpu.ops.marching_cubes import Mesh as JMesh
    from designcsg_tpu_torch.designs import get_design
    from designcsg_tpu_torch.evaluator import BatchEvaluator
    from designcsg_tpu_torch.export import preview, writers
    from designcsg_tpu_torch.export.active import extract_surface_active

    stl, png = str(tmp_path / "s.stl"), str(tmp_path / "p.png")
    ev = BatchEvaluator(get_design("design1"), device="cpu")
    writers.write_stl(stl, extract_surface_active(ev, np.zeros(3), 3.0, 32, slab_cells=16))
    cli.main(["preview", stl, png, "--size", "96"])
    img = cli.read_png(png)
    assert img.shape == (96, 96) and len(np.unique(img)) > 2
    mesh = writers.read_stl(stl)
    view = np.array([0.3, -0.4, 0.86])
    ours = preview.rasterize_mesh(mesh, view_dir=view, size=64)
    ref = jpreview.rasterize_mesh(JMesh(mesh.vertices, mesh.faces), view_dir=view, size=64)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(preview.fill_background_pinholes(ours),
                                  jpreview.fill_background_pinholes(ref))


@pytest.mark.parametrize("name", ["design1", "design2"])
def test_artifacts_command_matches_jax(tmp_path, name):
    from designcsg_tpu import api as japi

    import importlib

    cli.main(["artifacts", name, "-d", str(tmp_path / "torch")])
    jc = japi.new_design()
    importlib.import_module(f"designs.{name}").build(compiler=jc)
    (tmp_path / "jax").mkdir()
    jc.write_artifacts(str(tmp_path / "jax"))
    for f in ("scene.txt", "buildprocedure.txt", "arbitrary_data.hex"):
        assert (tmp_path / "torch" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def test_fit_command(tmp_path, capsys):
    out = tmp_path / "fit"
    cli.main(["fit", "design1", "-o", str(out), "--width", "32", "--height", "24",
              "--steps", "3", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "fitting 3 steps on 1 device(s)" in printed
    assert printed.count("max pos err") == 3
    state = load_checkpoint(str(out / "fit.ckpt"), device="cpu")
    assert state.step == 3 and tuple(state.params["position"].shape) == (11, 3)


def test_png_round_trip(tmp_path):
    rgb = np.random.default_rng(0).integers(0, 256, (7, 5, 3), dtype=np.uint8)
    cli.write_png(str(tmp_path / "a.png"), rgb)
    np.testing.assert_array_equal(cli.read_png(str(tmp_path / "a.png")), rgb)
