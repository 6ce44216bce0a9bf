"""The front end's last pieces in the PyTorch port against the JAX package, on
the CPU: the CPU route of Logo's frame (P7), ``load_reference_scene``, the
API's compatibility shims and the package's exports."""

import ast
import os

import matplotlib
import numpy as np
import pytest
import torch

import designcsg_tpu
import designcsg_tpu_torch
from designcsg_tpu.compiler import load_reference_scene as jload_reference_scene
from designcsg_tpu.ops import raymarch as jraymarch
from designcsg_tpu.config import RenderConfig as JRenderConfig
from designs import design2 as jdesign2
from designs import logo as jlogo
from designcsg_tpu_torch import api
from designcsg_tpu_torch.compiler import SCENE_ARRAY_FIELDS, load_reference_scene
from designcsg_tpu_torch.config import RenderConfig
from designcsg_tpu_torch.designs import design_module, get_design
from designcsg_tpu_torch.ops.interpreter import make_primary_sdf
from designcsg_tpu_torch.ops.raymarch import render_scene

FONT = os.path.join(
    os.path.dirname(matplotlib.__file__), "mpl-data", "fonts", "ttf", "DejaVuSansMono-Bold.ttf"
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the suite runs one process per
    worker, and a default-sized thread pool in each oversubscribes the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_cpu_logo_frame_matches_jax_render_scene():
    """P7: off the kernels, JAX's render_scene renders Logo on the exact
    letter field, through its compacted renderer (raymarch.py:633-651
    there); the port's render_scene(device="cpu") rendered it on the baked
    twin until it took the same route.  At 48x24 and 96 steps, by the
    port's render rule: max|d| < 1e-3, and the share of pixels with
    |d| > 1e-4 under 2% (measured on the CPU: max 3.1e-4, 1.65% of pixels,
    all letter pixels, where the two libraries' exact letter fields differ
    by rounding near the surface, tests/test_torch_proxy.py).  The baked
    frame of the earlier route is off by up to 0.68 on 7.2% of pixels."""
    kw = dict(width=48, height=24, max_steps=96)
    ours = render_scene(get_design("logo"), config=RenderConfig(**kw), device="cpu").numpy()
    ref = np.asarray(jraymarch.render_scene(jlogo.build(font_path=FONT), config=JRenderConfig(**kw)))
    diff = np.abs(ours - ref)
    assert (ref != 1.0).any(-1).mean() > 0.05  # letters and gizmo in view
    assert diff.max() < 1e-3
    assert (diff > 1e-4).any(-1).mean() < 0.02


def test_load_reference_scene_round_trip(tmp_path):
    """Design2's artifacts written by the port's own write_artifacts load
    back through the port's load_reference_scene into banks bit-equal to
    JAX's load_reference_scene of the same files, with the same register
    count and export config, and an SDF within 2e-5 of the compiled scene
    (the text rounds the frames to 6 decimals)."""
    c = api.new_design()
    design_module("design2").build(compiler=c)
    scene = c.write_artifacts(str(tmp_path))
    paths = [str(tmp_path / f) for f in ("scene.txt", "buildprocedure.txt")]
    extra = dict(arbitrary_data_path=str(tmp_path / "arbitrary_data.hex"),
                 export_config_path=str(tmp_path / "exportConfig.txt"))
    ours = load_reference_scene(*paths, brush_fns=scene.brush_fns, **extra)
    ref = jload_reference_scene(*paths, brush_fns=jdesign2.build().brush_fns, **extra)
    for f in SCENE_ARRAY_FIELDS:
        assert getattr(ours.arrays, f).tobytes() == np.asarray(getattr(ref.arrays, f)).tobytes(), f
    assert ours.num_registers == ref.num_registers
    assert ours.export_config == scene.export_config
    assert [type(f).__name__ for f in ours.material_fns] == ["function", "function"]
    pts = torch.from_numpy(np.random.default_rng(0).uniform(-6, 6, (4096, 3)).astype(np.float32))
    loaded = make_primary_sdf(ours)(pts, ours.arrays.to_torch("cpu"))
    compiled = make_primary_sdf(scene)(pts, scene.arrays.to_torch("cpu"))
    assert float((loaded - compiled).abs().max()) < 2e-5
    # The loaded scene has no CUDA bodies: it renders through the plain tape.
    assert render_scene(ours, config=RenderConfig(width=16, height=12, max_steps=32),
                        device="cpu").shape == (12, 16, 3)


def test_api_shims():
    """define_auxillary_function and add_preprocessor_define
    (api.py:259-280 of the JAX package): a callable passes through, a
    source string or a define raises a TypeError naming the port's way."""
    def helper(v):
        return v

    assert api.define_auxillary_function(helper) is helper
    assert api.define_auxillary_function(function=helper) is helper
    with pytest.raises(TypeError, match="torch"):
        api.define_auxillary_function("float helper(float x) { return x; }")
    with pytest.raises(TypeError, match="CUDA"):
        api.add_preprocessor_define("#define R 1")


def _exported(module) -> set:
    """The names a package's ``__init__`` imports from itself."""
    tree = ast.parse(open(module.__file__).read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            names.update(alias.asname or alias.name for alias in node.names)
        elif isinstance(node, ast.Assign) and node.targets[0].id == "__version__":
            names.add("__version__")
    return names


def test_package_exports_match_jax():
    """The port exports the JAX package's names (designcsg_tpu/__init__.py:
    89-101) beside ``resolve_device``, each an attribute of the package."""
    ref = _exported(designcsg_tpu)
    assert "load_reference_scene" in ref and "SceneCompiler" in ref
    assert _exported(designcsg_tpu_torch) == ref
    for name in ref | {"resolve_device"}:
        assert hasattr(designcsg_tpu_torch, name), name
    assert designcsg_tpu_torch.Transform is api.Transform
