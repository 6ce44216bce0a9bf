"""The port's Logo against the benchmark's plain reference of it
(benchmark/reference/logo.py) on the CPU: the exact field at seeded
points in four of the 24 axis poses, the point-sample pairs of one
evaluation, and the vertices of a small adaptive export on the
reference's zero set.  Also the spans of the exact letter brush and of
the host-point autodetect."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.reference import geometry
from benchmark.reference import logo as reference
from benchmark.reference import mesh as ref_mesh
from designcsg_tpu_torch import api
from designcsg_tpu_torch import observability as obs
from designcsg_tpu_torch.compiler import ExportConfig
from designcsg_tpu_torch.designs import design_module, logo
from designcsg_tpu_torch.evaluator import BatchEvaluator
from designcsg_tpu_torch.export.pipeline import autodetect_bounding_box, export_mesh
from designcsg_tpu_torch.ops.interpreter import make_normal_fn, make_primary_sdf

# Four of the 24 axis poses: the identity, a quarter turn, a half turn and
# one that permutes the axes.
TURNS = (None, 3, 11, 22)

# The program computes the squared distance in the affine form
# x^2 + y^2 + min_j(-2 s_j.p + |s_j|^2), the reference as (x - sx)^2 +
# (y - sy)^2.  Near a letter both terms are below (|p| + |s|)^2 <= 8, so the
# two squares differ by a few float32 ulps of 8: EPS2.  A distance d then
# differs by at most EPS2 / 2d, and by sqrt(EPS2) where d is near 0 (a point
# on a sample, inside its letter's mask).
EPS2 = 4e-6
# |field| in the reference past which a vertex is off the surface (the
# benchmark's OFF_GAP, benchmark/drivers/export_exact.py).
OFF_GAP = 1e-4


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
    return design_module("logo").build(compiler=compiler)


def exact_evaluator(turn=None):
    evaluator = BatchEvaluator(port_scene(turn), device="cpu", use_kernels=False)
    assert evaluator.sdf_field == "tape-exact"
    return evaluator


def rounding(ref):
    """The largest gap the affine form's rounding leaves at a point whose
    exact field reads ``ref``."""
    return 1e-5 + np.minimum(np.sqrt(EPS2), EPS2 / (2.0 * np.maximum(np.abs(ref), 1e-30)))


@pytest.mark.parametrize("turn", TURNS)
def test_field_matches_the_reference(turn):
    """The exact plain tape against the reference at 4,000 points over the
    whole export box and 4,000 over the letters' cube.  The signs come from
    the same mask cells, so the two differ by the distance's rounding only
    (``rounding``); a wrong mask cell or sample would differ by up to the
    letter's thickness, 0.075."""
    gen = torch.Generator().manual_seed(17)
    points = torch.cat([torch.rand(4_000, 3, generator=gen) * 12.0 - 6.0,
                        torch.rand(4_000, 3, generator=gen) * 7.0 - 3.5])
    got = exact_evaluator(turn).eval_sdf_at_points(points.numpy())
    ref = reference.design(rotation(turn)).field(points).numpy()
    assert (ref < 0).mean() > 0.01  # the points reach inside the letters
    assert (np.abs(got - ref) <= rounding(ref)).all(), np.abs(got - ref).max()


def test_samples_per_evaluation_are_the_programs_glyph_data():
    """One evaluation measures every sample of every letter: the program's
    segments (18, 28, 22) times its 64 samples a segment, 4,352; the
    reference reads the same segments and mask bits."""
    glyphs = logo.load_glyphs()
    assert [len(glyphs[ch][0]) for ch in "CSG"] == [18, 28, 22]
    assert sum(len(glyphs[ch][0]) for ch in "CSG") * logo.SUBSEGMENTS == 4352
    letters = reference.letters()
    assert sum(len(letters[ch].samples) for ch in "CSG") == reference.SAMPLES_PER_EVALUATION == 4352
    for ch in "CSG":
        segments, bits = glyphs[ch]
        assert letters[ch].samples.shape == (len(segments) * logo.SUBSEGMENTS, 2)
        assert np.array_equal(letters[ch].bits.numpy(), np.asarray(bits) == 1)
        np.testing.assert_allclose(letters[ch].samples.numpy(),
                                   logo._curve_samples_np(segments), rtol=0, atol=1e-6)


def test_small_adaptive_export_lies_on_the_reference_zero_set():
    """Octree 3 -> 5 at grid level 6 with a 32^3 autodetect (the
    configuration's 256^3 scan alone takes minutes here) and the
    configuration's 50 refine steps.  Most vertices read under 1e-6 in the
    reference.  A few end where the letter's mask cell is inside, on or
    beside a sample of the outline, where the field is -d and touches 0
    (3% of them here): they read the same in the program, within the
    affine form's rounding there, sqrt(EPS2)."""
    evaluator = exact_evaluator()
    config = dataclasses.replace(ExportConfig(), minimum_octree_level=3, maximum_octree_level=5,
                                 grid_level=6)
    assert config.gradient_descent_steps == 50
    mesh, report = export_mesh(evaluator.scene, config, evaluator=evaluator,
                               autodetect_resolution=32)
    assert report.stats["strategy"] == "adaptive" and report.stats["sdf_field"] == "tape-exact"
    assert mesh.num_faces > 5000
    ref = ref_mesh.field_at(reference.design(), mesh.vertices, "cpu")
    gap = np.abs(ref)
    assert np.median(gap) < 1e-6
    off = gap > OFF_GAP
    assert 0 < off.mean() < 0.05
    got = evaluator.eval_sdf_at_points(mesh.vertices[off])
    assert (np.abs(got - ref[off]) <= np.sqrt(EPS2)).all()


def test_refine_stays_put_on_an_outline_sample():
    """At a sample of C's outline, halfway through its plate, the exact
    field is 0 and its six differences cancel at many samples: the FD
    normal is then the zero vector, as OpenCL's normalize gives it, and a
    refine leaves the point where it is, where g / |g| made it NaN."""
    evaluator = exact_evaluator()
    samples = reference.letters()["C"].samples.numpy()
    # C's frame is (x, y, -z) under the root's 5: the plate's middle lies at
    # letter z = 1.1875, local z 0.59375.
    points = np.stack([2.5 * samples[:, 0], 2.5 * samples[:, 1],
                       np.full(len(samples), -5.0 * 0.59375)], 1).astype(np.float32)
    normals = evaluator.eval_normal_at_points(points)
    flat = (normals == 0.0).all(1)
    assert np.isfinite(normals).all() and flat.sum() > 10
    refined = evaluator.refine_on_device(points, steps=3)
    assert np.isfinite(refined).all()
    np.testing.assert_array_equal(refined[flat], points[flat])


@pytest.mark.parametrize("name", ["logo", "design1"])
def test_refine_on_the_tape_is_the_point_and_normal_loop(name):
    """The exact tape's refine evaluates each step's seven points in one
    tape call (``make_sdf_fd_normal``); the tape is pointwise, so it equals
    a point evaluation and an FD normal per step, bit for bit, with Logo's
    affine matmul too."""
    scene = port_scene(None) if name == "logo" else design_module(name).build()
    evaluator = BatchEvaluator(scene, device="cpu", use_kernels=False, chunk_size=700)
    v = np.random.default_rng(8).uniform(-3.4, 3.4, (1500, 3)).astype(np.float32)
    got = evaluator.refine_on_device(v, steps=3)
    sdf = make_primary_sdf(scene)
    normal = make_normal_fn(sdf)
    arrays = scene.arrays.to_torch("cpu")
    ref = np.empty_like(v)
    for start in range(0, len(v), 700):
        p = torch.from_numpy(v[start : start + 700])
        for _ in range(3):
            p = p - 1.0 * normal(p, arrays) * sdf(p, arrays)[:, None]
        ref[start : start + len(p)] = p.numpy()
    np.testing.assert_array_equal(got, ref)
    assert evaluator.sdf_eval_count == 3 * len(v) * 7
    assert np.abs(got - v).max() > 1e-3


def test_letter_spans_count_the_point_sample_pairs():
    """Over a traced point evaluation and FD normals, the ``brush.letter``
    values sum to the evaluator's count times 4,352, each letter's calls
    carrying its own samples, and each sits inside an evaluator call."""
    evaluator = exact_evaluator()
    points = np.random.default_rng(5).uniform(-3.5, 3.5, (300, 3)).astype(np.float32)
    obs.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        evaluator.eval_sdf_at_points(points)
        evaluator.eval_normal_at_points(points[:100])
    spans = list(obs.spans())
    letters = [s for s in spans if s[0] == "brush.letter"]
    assert evaluator.sdf_eval_count == 300 + 6 * 100
    assert sum(s[4] for s in letters) == evaluator.sdf_eval_count * 4352
    assert sorted({s[4] for s in letters}) == sorted(
        n * k for n in (300, 100) for k in (18 * 64, 28 * 64, 22 * 64))
    assert all(spans[s[3]][0].startswith("evaluator.") for s in letters)


def test_host_autodetect_span_carries_its_points():
    """The host-point autodetect is one span whose value is the points it
    scans, its evaluations inside it; the box is the untraced one's."""
    evaluator = exact_evaluator()
    center, half = autodetect_bounding_box(evaluator, 10.0, 16)
    obs.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = autodetect_bounding_box(evaluator, 10.0, 16)
    spans = list(obs.spans())
    (scan,) = [i for i, s in enumerate(spans) if s[0] == "evaluator.autodetect_bounding_box"]
    assert spans[scan][3] == -1 and spans[scan][4] == 16**3
    inner = [s for s in spans if s[3] == scan]
    assert inner and {s[0] for s in inner} == {"evaluator.eval_sdf_at_points"}
    assert np.array_equal(traced[0], center) and traced[1] == half
    assert evaluator.sdf_eval_count == 2 * 16**3
