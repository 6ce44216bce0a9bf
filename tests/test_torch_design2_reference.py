"""The port's Design2 against the benchmark's plain reference of it
(benchmark/reference/design2.py) on the CPU: the field at seeded points in
four of the 24 axis poses, the FP32 operation count of one evaluation,
and the vertices of a small adaptive export on the reference's zero set.
Also the spans inside the adaptive extract's mesh ops, on Design1's
export."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.reference import design2 as reference
from benchmark.reference import geometry, render
from benchmark.reference import mesh as ref_mesh
from designcsg_tpu_torch import api
from designcsg_tpu_torch import observability as obs
from designcsg_tpu_torch.compiler import ExportConfig
from designcsg_tpu_torch.designs import design_module, get_design
from designcsg_tpu_torch.evaluator import BatchEvaluator
from designcsg_tpu_torch.export import adaptive
from designcsg_tpu_torch.export.pipeline import export_mesh
from designcsg_tpu_torch.ops import cull

# Four of the 24 axis poses: the identity, a quarter turn, a half turn and
# one that permutes the axes.
TURNS = (None, 3, 11, 22)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the suite runs one process per
    worker, and a default-sized thread pool in each oversubscribes the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rotation(turn):
    return None if turn is None else geometry.axis_rotations()[turn]


def port_scene(turn):
    compiler = api.new_design()
    if turn is not None:
        root = np.eye(4)
        root[:3, :3] = rotation(turn)
        compiler.root.apply_transform(root)
    return design_module("design2").build(compiler=compiler)


@pytest.mark.parametrize("turn", TURNS)
def test_field_matches_the_reference(turn):
    """The plain evaluator's field against the reference at 20,000 points
    over the whole export box and 20,000 over the part.  The two compute
    the same float32 operations: the port picks each quadrant coordinate
    as +-w where the reference multiplies by 0 and +-1 and adds, which is
    exact, so only the order of the frame's sums may round differently;
    1e-5 bounds a few such roundings of coordinates of size ~5, scaled by
    the brush's 3x quadrant frame."""
    gen = torch.Generator().manual_seed(11)
    points = torch.cat([torch.rand(20_000, 3, generator=gen) * 12.0 - 6.0,
                        torch.rand(20_000, 3, generator=gen) * 6.0 - 3.0])
    evaluator = BatchEvaluator(port_scene(turn), device="cpu", use_kernels=False)
    got = evaluator.eval_sdf_at_points(points.numpy())
    ref = reference.design(rotation(turn)).field(points).numpy()
    assert (ref < 0).mean() > 0.01  # the points reach inside the part
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_flop_count_is_the_programs():
    """One evaluation: each tape slot's brush (its ``cuda_flops``) and
    frame transform, and each MIN/MAX/NEGATE, as the kernels' bounds count
    them; 762 + 14 for the brushes."""
    scene = port_scene(None)
    program = 0
    for opcode, left, _, _ in scene.arrays.tape:
        if opcode == 0:  # IMPORT
            program += cull.leaf_cost(scene, int(left))
        elif opcode in (2, 3, 4):  # MIN, MAX, NEGATE
            program += 1
    assert reference.hilbert.flops == 762 and reference.base.flops == 14
    assert render.field_flops(reference.design(), gizmo=False) == program == 814


@pytest.mark.parametrize("turn", [None, 7])
def test_small_adaptive_export_lies_on_the_reference_zero_set(turn):
    """Octree 3 -> 5 at grid level 6 with a 32^3 autodetect, as
    test_torch_adaptive_design2.py runs it, but with the configuration's
    50 refine steps: 2 steps leave vertices ~0.03 off the surface, which
    would say nothing of it.  After 50 steps every vertex reads under 5e-7
    in the reference; 1e-5 leaves room for rounding, while a vertex left
    at its lattice edge's midpoint reads up to a few hundredths."""
    scene = port_scene(turn)
    config = dataclasses.replace(scene.export_config, minimum_octree_level=3,
                                 maximum_octree_level=5, grid_level=6)
    assert config.gradient_descent_steps == 50
    mesh, report = export_mesh(scene, config, autodetect_resolution=32, device="cpu")
    assert report.stats["strategy"] == "adaptive" and mesh.num_faces > 1000
    gap = np.abs(ref_mesh.field_at(reference.design(rotation(turn)), mesh.vertices, "cpu"))
    assert gap.max() < 1e-5


def test_mesh_op_spans_nest_in_mesh_ops_and_carry_the_faces_they_receive(monkeypatch, tmp_path):
    """Design1's small adaptive export under the profiler: extract.weld,
    extract.retopologize and extract.stitch, in that order, are the
    children of extract.mesh_ops, and each span's value is the faces its
    operation received (the weld: the emitted triangles, 3 keys each)."""
    received = {}

    def spy(name, fn, faces):
        def call(*args, **kwargs):
            received[name] = faces(args[0])
            return fn(*args, **kwargs)
        monkeypatch.setattr(adaptive, fn.__name__, call)

    spy("extract.weld", adaptive.assemble_mesh, lambda keys: sum(k.size for k in keys) // 3)
    spy("extract.retopologize", adaptive.retopologize, lambda mesh: mesh.num_faces)
    spy("extract.stitch", adaptive.stitch_boundary_loops, lambda mesh: mesh.num_faces)
    scene = get_design("design1")
    config = ExportConfig(bounding_box_half_diameter=10.0, minimum_octree_level=3,
                          maximum_octree_level=5, grid_level=5, complex_surface_threshold=0.3,
                          gradient_descent_steps=2)
    obs.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        mesh, _ = export_mesh(scene, config, stl_path=str(tmp_path / "a.stl"),
                              evaluator=BatchEvaluator(scene, device="cpu", use_kernels=True),
                              autodetect_resolution=32, strategy="adaptive")
    spans = list(obs.spans())
    (ops,) = [i for i, s in enumerate(spans) if s[0] == "extract.mesh_ops"]
    inside = [(i, s) for i, s in enumerate(spans) if s[3] == ops]
    assert [s[0] for _, s in inside] == ["extract.weld", "extract.retopologize", "extract.stitch"]
    assert not [s for s in spans if s[3] in {i for i, _ in inside}]  # nothing below them
    for _, (name, start, end, _, value) in inside:
        assert spans[ops][1] <= start <= end <= spans[ops][2]
        assert value == received[name] > 0
    assert received["extract.weld"] >= received["extract.retopologize"] > 0
    assert mesh.num_faces > 0
