"""Scene compiler of the PyTorch port against the JAX package: Design1's tape,
ids and banks bit-equal, reference artifacts byte-equal, SceneArrays carried
across, and the package standing alone without JAX."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import designs
from designcsg_tpu import api as japi
from designcsg_tpu_torch import api as tapi
from designcsg_tpu_torch.compiler import (
    SCENE_ARRAY_FIELDS,
    SceneArrays,
    scene_arrays_from_numpy,
)
from designcsg_tpu_torch.designs import design1 as tdesign1
from designcsg_tpu_torch.designs import get_design

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the suite runs one process per
    worker, and a default-sized thread pool in each oversubscribes the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_fields(arrays):
    return {f: np.asarray(getattr(arrays, f)) for f in SCENE_ARRAY_FIELDS}


def test_design1_arrays_bit_equal():
    ours = get_design("design1")
    ref = designs.get_design("design1")
    for f in SCENE_ARRAY_FIELDS:
        a, b = getattr(ours.arrays, f), np.asarray(getattr(ref.arrays, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    assert ours.num_registers == ref.num_registers
    assert ours.export_config.to_lines() == ref.export_config.to_lines()
    assert len(ours.brush_fns) == len(ref.brush_fns) == 7
    assert all(ours.brush_cuda) and all(ours.material_cuda)
    assert ours.brush_flops == (0, 0, 7, 8, 8, 7, 8)


def test_design1_tape_flops():
    """The bound's operation count: 9 spheres (7) and a box (8), each through
    an 18-operation frame transform, plus 2 MIN, 8 MAX and 8 NEGATE; the
    empty root import costs nothing."""
    sys.path.insert(0, REPO)
    import chip_smoke

    assert chip_smoke.tape_ops(get_design("design1")) == 9 * (7 + 18) + (8 + 18) + 18


def test_write_artifacts_byte_equal(tmp_path):
    from designs import design1 as jdesign1

    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    jc = japi.new_design()
    jdesign1.build(compiler=jc)
    jc.write_artifacts(str(tmp_path / "jax"))
    tc = tapi.new_design()
    tdesign1.build(compiler=tc)
    tc.write_artifacts(str(tmp_path / "torch"))
    names = ["scene.txt", "buildprocedure.txt", "arbitrary_data.hex", "exportConfig.txt"]
    for name in names:
        assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name


def test_scene_arrays_from_numpy_round_trip():
    ref = designs.get_design("design1").arrays
    ours = scene_arrays_from_numpy(_jax_fields(ref))
    assert isinstance(ours, SceneArrays)
    for f in SCENE_ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(ours, f), np.asarray(getattr(ref, f)))
        assert getattr(ours, f).dtype == np.asarray(getattr(ref, f)).dtype
    back = scene_arrays_from_numpy({f: getattr(ours, f) for f in SCENE_ARRAY_FIELDS})
    assert back.content_digest() == ours.content_digest()
    moved = ours.to_torch("cpu")
    assert all(isinstance(t, torch.Tensor) for t in moved.fields())
    assert moved.content_digest() == ours.content_digest()
    with pytest.raises(KeyError):
        scene_arrays_from_numpy({"shape_id": ours.shape_id})


def test_intersection_and_subtraction_tape_equal():
    """A tape with every join mode: union group, intersection, subtraction."""

    def build(api):
        c = api.new_design()
        t = api.Transform.initial(position=[0.2, 0, 0], yaw=0.3, pitch=0.1, roll=0, scale=[1.0] * 3)
        a = api.Component(api.sphere_brush(c), t, compiler=c)
        b = api.Component(api.box_brush(c), api.Transform.identity(), compiler=c)
        api.drawIntersection(a, b, compiler=c)
        api.draw_capsule([0, -1, 0], [0, 1, 0], 0.5, compiler=c)
        api.eraseUnion(api.Component(api.cylinder_brush(c), t, compiler=c), compiler=c)
        return c.commit()

    ours, ref = build(tapi), build(japi)
    for f in SCENE_ARRAY_FIELDS:
        assert getattr(ours.arrays, f).tobytes() == np.asarray(getattr(ref.arrays, f)).tobytes(), f


def test_port_stands_alone_without_jax():
    """Importing and running the port's CPU path, its shells (observability,
    viewer, studio, cli, bench), one studio render of the new-design template
    and one bench cell, with jax, designcsg_tpu, designs and the root
    bench.py unimportable."""
    code = textwrap.dedent(
        """
        import sys
        for name in ("jax", "jaxlib", "designcsg_tpu", "designs", "bench"):
            sys.modules[name] = None
        import dataclasses
        import numpy as np, torch
        from designcsg_tpu_torch.config import RenderConfig
        from designcsg_tpu_torch.designs import get_design
        from designcsg_tpu_torch.evaluator import BatchEvaluator
        from designcsg_tpu_torch.export.pipeline import export_mesh
        from designcsg_tpu_torch.ops.raymarch import render_scene, to_u8
        scene = get_design("design1")
        ev = BatchEvaluator(scene, device="cpu")
        assert ev.eval_sdf_at_points(np.zeros((1, 3), np.float32))[0] < 0
        img = to_u8(render_scene(scene, config=RenderConfig(width=32, height=24, max_steps=64), device="cpu"))
        assert img.shape == (24, 32, 3)
        cfg = dataclasses.replace(scene.export_config, grid_level=4, gradient_descent_steps=2)
        mesh, report = export_mesh(scene, export_config=cfg, autodetect_resolution=16,
                                   strategy="dense", device="cpu")
        assert report.num_triangles > 0
        import tempfile
        from designcsg_tpu_torch import bench, cli, observability, studio, viewer
        with tempfile.TemporaryDirectory() as tmp:
            session = studio.StudioSession(studio.Workspace(tmp), width=32, height=24, device="cpu")
            assert session.run_text(studio.NEW_DESIGN_TEMPLATE)
            assert session.render_png()[1:4] == b"PNG"
        assert bench.grid_cell(scene, 8, 2, "cpu")["slab"].shape == (4, 8, 8)
        assert not any(m.split(".")[0] in ("jax", "designcsg_tpu", "designs", "bench")
                       for m, v in sys.modules.items() if v is not None)
        print("standalone ok")
        """
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert "standalone ok" in out.stdout


def test_entry_points_raise_without_a_card():
    """With no card, an entry point asked for no device raises instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid here")
    from designcsg_tpu_torch.evaluator import BatchEvaluator
    from designcsg_tpu_torch.ops.raymarch import render_scene

    scene = get_design("design1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchEvaluator(scene)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_scene(scene)
    assert BatchEvaluator(scene, device="cpu").device.type == "cpu"
