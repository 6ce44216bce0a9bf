"""The port's adaptive extraction (export/adaptive.py) on the CPU: the
reference's octree criteria as a level sweep (tests/test_adaptive.py's
cases), its export and crash resume (tests/test_resume.py's adaptive cases),
and Design1's adaptive export against the JAX package's: the same triangle
set, per-level counts, SDF evaluations and zero boundary edges.

Against JAX the export runs its own autodetect, as ``cli export`` does: on a
box of round numbers (half diameter 10 about the origin) lattice corners fall
on Design1's faces, where the SDF is exactly 0 in the JAX package and -3e-8
in the port (tests/test_torch_evaluator.py), and a corner's sign then picks
the marching-cubes case.
"""

import dataclasses

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import designs
from designcsg_tpu import native as jnative
from designcsg_tpu.export import pipeline as jpipeline
from designcsg_tpu_torch import native
from designcsg_tpu_torch.compiler import ExportConfig
from designcsg_tpu_torch.designs import get_design
from designcsg_tpu_torch.evaluator import BatchEvaluator
from designcsg_tpu_torch.export import adaptive as A
from designcsg_tpu_torch.export.active import extract_surface_active
from designcsg_tpu_torch.export.pipeline import export_mesh
from designcsg_tpu_torch.export.retopo import boundary_edges


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the suite runs one process per
    worker, and a default-sized thread pool in each oversubscribes the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def design1_eval():
    return BatchEvaluator(get_design("design1"), device="cpu")


def _mesh_samples(mesh):
    tri = mesh.vertices[mesh.faces]
    pts = [mesh.vertices, tri.mean(axis=1)]
    for a, b in [(0, 1), (1, 2), (0, 2)]:
        pts.append((tri[:, a] + tri[:, b]) / 2)
    return np.concatenate(pts)


def sampled_hausdorff(a, b):
    sa, sb = _mesh_samples(a), _mesh_samples(b)
    return max(cKDTree(sb).query(sa)[0].max(), cKDTree(sa).query(sb)[0].max())


@pytest.fixture(scope="module")
def adaptive_mesh(design1_eval):
    cfg = ExportConfig(bounding_box_half_diameter=10.0, minimum_octree_level=4,
                       maximum_octree_level=6, grid_level=6, complex_surface_threshold=0.3)
    stats = {}
    mesh = A.extract_surface_adaptive(design1_eval, np.zeros(3), 10.0, cfg, stats=stats)
    return mesh, stats, cfg


def test_consumes_octree_levels(adaptive_mesh):
    _, stats, cfg = adaptive_mesh
    levels = stats["level_triangles"]
    assert min(levels) >= cfg.minimum_octree_level and max(levels) <= cfg.maximum_octree_level
    assert len(levels) >= 2, levels
    assert set(stats["level_seconds"]) == set(range(4, 7))


def test_watertight_across_level_transitions(adaptive_mesh):
    mesh, stats, _ = adaptive_mesh
    assert mesh.num_faces > 0 and boundary_edges(mesh).shape[0] == 0
    assert stats.get("open_loops", 0) == 0


def test_fewer_triangles_at_equal_fidelity(design1_eval, adaptive_mesh):
    mesh, _, cfg = adaptive_mesh
    res = 1 << cfg.maximum_octree_level
    uniform = extract_surface_active(design1_eval, np.zeros(3), 10.0, res, slab_cells=16)
    assert mesh.num_faces < uniform.num_faces
    assert sampled_hausdorff(mesh, uniform) < 2.0 * 10.0 / res
    grid = extract_surface_active(design1_eval, np.zeros(3), 10.0, 1 << 7, slab_cells=16)
    assert grid.num_faces >= 3 * mesh.num_faces


def test_threshold_monotonicity(design1_eval):
    counts = []
    for thr in (0.15, 3.0):
        cfg = ExportConfig(bounding_box_half_diameter=10.0, minimum_octree_level=4,
                           maximum_octree_level=5, grid_level=5, complex_surface_threshold=thr)
        counts.append(A.extract_surface_adaptive(design1_eval, np.zeros(3), 10.0, cfg).num_faces)
    assert counts[0] > counts[1]


def test_min_equals_max_matches_uniform_topology(design1_eval):
    cfg = ExportConfig(bounding_box_half_diameter=10.0, minimum_octree_level=5,
                       maximum_octree_level=5, grid_level=5)
    adaptive = A.extract_surface_adaptive(design1_eval, np.zeros(3), 10.0, cfg)
    uniform = extract_surface_active(design1_eval, np.zeros(3), 10.0, 1 << 5, slab_cells=16)
    assert adaptive.num_faces == uniform.num_faces


def test_edge_sample_cap_matches_uncapped(design1_eval, monkeypatch):
    cfg = ExportConfig(bounding_box_half_diameter=10.0, minimum_octree_level=2,
                       maximum_octree_level=3, grid_level=8, gradient_descent_steps=0)
    capped = A.extract_surface_adaptive(design1_eval, np.zeros(3), 10.0, cfg, heal=False)
    assert A._MAX_EDGE_SAMPLES == 7
    monkeypatch.setattr(A, "_MAX_EDGE_SAMPLES", 10**9)
    uncapped = A.extract_surface_adaptive(design1_eval, np.zeros(3), 10.0, cfg, heal=False)
    assert capped.num_faces == uncapped.num_faces
    np.testing.assert_array_equal(np.sort(capped.vertices.reshape(-1)),
                                  np.sort(uncapped.vertices.reshape(-1)))


def test_adaptive_reference_scale_grid256(design1_eval):
    """Design1's own export configuration (octree 5 -> 7, grid 2^8):
    watertight, every level emits, fewer triangles than uniform at 128^3."""
    cfg = ExportConfig(bounding_box_half_diameter=10.0, minimum_octree_level=5,
                       maximum_octree_level=7, grid_level=8, gradient_descent_steps=0)
    stats = {}
    mesh = A.extract_surface_adaptive(design1_eval, np.zeros(3), 10.0, cfg, stats=stats)
    assert mesh.num_faces > 2_000 and boundary_edges(mesh).shape[0] == 0
    assert stats.get("open_loops", 0) == 0
    hist = stats["level_triangles"]
    assert set(hist) <= {5, 6, 7} and hist[5] > 0 and hist[7] > 0
    assert mesh.num_faces < extract_surface_active(design1_eval, np.zeros(3), 10.0, 128).num_faces


def _keyed_faces(mesh):
    f = mesh.faces
    k = np.argmin(f, axis=1)
    rolled = np.stack([f[np.arange(len(f)), (k + i) % 3] for i in range(3)], 1)
    return rolled[np.lexsort(rolled.T[::-1])]


@pytest.mark.parametrize("levels", [(3, 5, 5), (2, 4, 5)])
def test_design1_adaptive_export_matches_jax(levels):
    """``export_mesh`` at its default strategy ("auto" -> adaptive) on both
    packages, numpy welds on both sides, 2 refine steps: the same faces, the
    vertices within 1e-4 (tests/test_torch_export.py's rule after
    refinement), the same per-level triangle counts and SDF evaluations,
    and zero boundary edges."""
    lo, hi, grid = levels
    kw = dict(minimum_octree_level=lo, maximum_octree_level=hi, grid_level=grid,
              gradient_descent_steps=2)
    jscene, tscene = designs.get_design("design1"), get_design("design1")
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "available", lambda: False)
    mp.setattr(native, "available", lambda: False)
    try:
        jm, jr = jpipeline.export_mesh(jscene, dataclasses.replace(jscene.export_config, **kw),
                                       autodetect_resolution=32)
        tm, tr = export_mesh(tscene, dataclasses.replace(tscene.export_config, **kw),
                             autodetect_resolution=32, device="cpu")
    finally:
        mp.undo()
    assert tr.stats["strategy"] == "adaptive"
    assert tr.stats["level_triangles"] == jr.stats["level_triangles"]
    assert len(tr.stats["level_triangles"]) >= 2
    assert tr.sdf_evals == jr.sdf_evals
    assert tm.num_faces == jm.num_faces > 0
    np.testing.assert_array_equal(_keyed_faces(tm), _keyed_faces(jm))
    np.testing.assert_allclose(tm.vertices, jm.vertices, rtol=0, atol=1e-4)
    assert boundary_edges(tm).shape[0] == 0
    assert tr.stats.get("open_loops", 0) == jr.stats.get("open_loops", 0) == 0


class CrashAfter:
    """Progress callback that raises once extraction passes a fraction."""

    def __init__(self, frac):
        self.frac = frac

    def __call__(self, stage, frac):
        if stage == "EXTRACTING_SURFACE" and frac >= self.frac:
            raise RuntimeError("simulated crash")


RESUME_CFG = ExportConfig(bounding_box_half_diameter=10.0, minimum_octree_level=2,
                          maximum_octree_level=4, grid_level=5, gradient_descent_steps=2)


def test_adaptive_crash_resume_identical_mesh(tmp_path):
    """One shard per completed level: a crash resumes at the level in
    flight, and the finished mesh is the uninterrupted one."""
    import glob
    import os

    scene = get_design("design1")
    kw = dict(autodetect=False, strategy="adaptive", device="cpu")
    ref_mesh, _ = export_mesh(scene, RESUME_CFG, **kw)
    resume = str(tmp_path / "adaptive")
    with pytest.raises(RuntimeError, match="simulated crash"):
        export_mesh(scene, RESUME_CFG, resume_dir=resume, progress=CrashAfter(0.5), **kw)
    shards = glob.glob(os.path.join(resume, "slab_*.npz"))
    assert 0 < len(shards) < 3
    ev = BatchEvaluator(scene, device="cpu")
    mesh, report = export_mesh(scene, RESUME_CFG, evaluator=ev, resume_dir=resume, **kw)
    np.testing.assert_array_equal(mesh.faces, ref_mesh.faces)
    np.testing.assert_array_equal(mesh.vertices, ref_mesh.vertices)
    assert report.sdf_evals == ev.sdf_eval_count


def test_adaptive_report_counts_real_evals():
    cfg = dataclasses.replace(RESUME_CFG, grid_level=4)
    ev = BatchEvaluator(get_design("design1"), device="cpu")
    _, report = export_mesh(get_design("design1"), cfg, evaluator=ev, autodetect=False,
                            strategy="adaptive")
    assert report.sdf_evals == ev.sdf_eval_count
    res = 1 << cfg.grid_level
    dense_formula = (res + 1) ** 2 * (res + -(-res // 32))
    assert 0 < report.sdf_evals - 2 * cfg.gradient_descent_steps * 7 != dense_formula


def test_pipeline_strategy_adaptive_writes_stl(tmp_path):
    scene = get_design("design1")
    cfg = ExportConfig(bounding_box_half_diameter=10.0, minimum_octree_level=3,
                       maximum_octree_level=5, grid_level=5, complex_surface_threshold=0.3,
                       gradient_descent_steps=3)
    mesh, report = export_mesh(scene, cfg, stl_path=str(tmp_path / "a.stl"), strategy="adaptive",
                               autodetect=False, device="cpu")
    assert mesh.num_faces > 0 and report.stats["native"] == native.available()
    assert sum(report.stats["level_triangles"].values()) >= mesh.num_faces
    d = np.abs(BatchEvaluator(scene, device="cpu").eval_sdf_at_points(mesh.vertices))
    assert np.median(d) < 0.05
    assert (tmp_path / "a.stl").stat().st_size == 84 + 50 * mesh.num_faces
