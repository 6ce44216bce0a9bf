"""Dense mesh export of the PyTorch port against the JAX package, on the CPU."""

import dataclasses

import numpy as np
import pytest

import designs
from designcsg_tpu import native as jnative
from designcsg_tpu.evaluator import BatchEvaluator as JBatchEvaluator
from designcsg_tpu.export import pipeline as jpipeline
from designcsg_tpu.export import writers as jwriters
from designcsg_tpu_torch.designs import get_design
from designcsg_tpu_torch.evaluator import BatchEvaluator
from designcsg_tpu_torch.export import pipeline as tpipeline
from designcsg_tpu_torch.export import writers as twriters
from designcsg_tpu_torch.ops.marching_cubes import Mesh


@pytest.fixture(scope="module")
def exports():
    """(steps -> (jax mesh, jax report, port mesh, port report)) for the dense
    export at grid level 5 with a 32^3 autodetect, before refinement (0 steps)
    and after 5 steps.  The JAX side runs its numpy meshing path, the one the
    port carries (its native weld orders vertices differently)."""
    jscene, tscene = designs.get_design("design1"), get_design("design1")
    out = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "available", lambda: False)
    try:
        for steps in (0, 5):
            kw = dict(autodetect_resolution=32, strategy="dense")
            jm, jr = jpipeline.export_mesh(
                jscene,
                export_config=dataclasses.replace(
                    jscene.export_config, grid_level=5, gradient_descent_steps=steps
                ),
                **kw,
            )
            tm, tr = tpipeline.export_mesh(
                tscene,
                export_config=dataclasses.replace(
                    tscene.export_config, grid_level=5, gradient_descent_steps=steps
                ),
                device="cpu",
                **kw,
            )
            out[steps] = (jm, jr, tm, tr)
    finally:
        mp.undo()
    return out


def test_bounding_box_matches(exports):
    _, jr, _, tr = exports[0]
    np.testing.assert_allclose(tr.bounding_box_center, jr.bounding_box_center, atol=1e-6)
    assert abs(tr.bounding_box_half_diameter - jr.bounding_box_half_diameter) <= 1e-6
    assert tr.sdf_evals == jr.sdf_evals


@pytest.mark.parametrize("steps,atol", [(0, 1e-5), (5, 1e-4)])
def test_faces_equal_vertices_close(exports, steps, atol):
    jm, jr, tm, tr = exports[steps]
    assert tm.num_faces > 0
    np.testing.assert_array_equal(tm.faces, jm.faces)
    np.testing.assert_allclose(tm.vertices, jm.vertices, atol=atol)
    assert tr.num_triangles == jr.num_triangles


def test_device_autodetect_matches_host(exports):
    """The device autodetect (grid eval + masked reductions) finds the same
    box as the host-point scan."""
    ev = BatchEvaluator(get_design("design1"), device="cpu")
    a = tpipeline.autodetect_bounding_box_device(ev, 10.0, 32)
    b = tpipeline.autodetect_bounding_box(ev, 10.0, 32)
    np.testing.assert_allclose(a[0], b[0], atol=1e-6)
    assert abs(a[1] - b[1]) <= 1e-6


def test_unported_strategies_raise():
    scene = get_design("design1")
    for strategy in ("auto", "active", "adaptive", "compact"):
        with pytest.raises(NotImplementedError, match="item 8"):
            tpipeline.export_mesh(scene, strategy=strategy, device="cpu")


def test_writers_byte_equal(tmp_path, exports):
    jm, _, _, _ = exports[5]
    mesh = Mesh(vertices=jm.vertices, faces=jm.faces)
    for writer, reader in (("write_stl", "read_stl"), ("write_ply", "read_ply")):
        ours, ref = str(tmp_path / f"t_{writer}"), str(tmp_path / f"j_{writer}")
        getattr(twriters, writer)(ours, mesh)
        getattr(jwriters, writer)(ref, mesh)
        with open(ours, "rb") as a, open(ref, "rb") as b:
            assert a.read() == b.read(), writer
        back = getattr(twriters, reader)(ours)
        assert back.num_faces == mesh.num_faces


def test_resume_reuses_slabs(tmp_path):
    scene = get_design("design1")
    cfg = dataclasses.replace(scene.export_config, grid_level=4, gradient_descent_steps=1)
    kw = dict(export_config=cfg, autodetect_resolution=16, strategy="dense", device="cpu",
              resume_dir=str(tmp_path), slab_cells=8)
    m1, _ = tpipeline.export_mesh(scene, **kw)
    m2, _ = tpipeline.export_mesh(scene, **kw)
    np.testing.assert_array_equal(m1.faces, m2.faces)
    np.testing.assert_array_equal(m1.vertices, m2.vertices)
