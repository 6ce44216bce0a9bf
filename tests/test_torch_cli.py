"""The port's CLI (``python -m designcsg_tpu_torch.cli``) in process on the
CPU, mirroring tests/test_cli.py: render (also ``--fast``), render by script
path, export, artifacts against the JAX package's ``write_artifacts``, fit,
and the commands that are not ported yet."""

import os

import numpy as np
import pytest

from designcsg_tpu_torch import cli
from designcsg_tpu_torch.config import RenderConfig
from designcsg_tpu_torch.parallel.fit import load_checkpoint


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


def test_export_command(tmp_path):
    stl = str(tmp_path / "d1.stl")
    cli.main(["export", "design1", "--stl", stl, "--grid-level", "4", "--device", "cpu"])
    assert os.path.getsize(stl) > 84


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


@pytest.mark.parametrize("command", sorted(cli.UNPORTED))
def test_unported_commands_exit_naming_roadmap(command):
    with pytest.raises(SystemExit, match="ROADMAP.md") as exc:
        cli.main([command, "design1"])
    assert exc.value.code != 0
