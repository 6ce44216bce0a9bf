"""The port's crack healing (export/retopo.py), which splits the touched
triangles of ``retopologize`` and caps the loops of
``stitch_boundary_loops`` many at a time, against the JAX package's, which
takes one triangle or loop at a time: the same caps, triangle for
triangle, and the same healed meshes, on synthetic sheets and on the mesh
a multi-level Design2 export heals."""

import dataclasses

import numpy as np
import pytest
import torch

from designcsg_tpu.export import retopo as jretopo
from designcsg_tpu.ops.marching_cubes import Mesh as JMesh
from designcsg_tpu_torch.designs import get_design
from designcsg_tpu_torch.export import adaptive, retopo
from designcsg_tpu_torch.export.pipeline import export_mesh
from designcsg_tpu_torch.ops.marching_cubes import Mesh


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the suite runs one process per
    worker, and a default-sized thread pool in each oversubscribes the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_loops(seed, lengths):
    """Near-planar polygons of the given lengths at scales from 0.01 to 3,
    some with a repeated point (equal-cost splits), as float32 vertices."""
    rng = np.random.default_rng(seed)
    loops, verts, base = [], [], 0
    for m in lengths:
        a = np.sort(rng.uniform(0.0, 2.0 * np.pi, m))
        pts = np.stack([np.cos(a), np.sin(a), rng.normal(0.0, 0.01, m)], 1)
        pts *= rng.uniform(0.01, 3.0)
        if rng.random() < 0.3:
            pts[rng.integers(m)] = pts[rng.integers(m)]
        verts.append(pts.astype(np.float32))
        loops.append(list(range(base, base + m)))
        base += m
    return loops, np.concatenate(verts)


@pytest.mark.parametrize("lengths", [list(range(3, 17)) * 4, list(range(40, 65, 3))],
                         ids=["short", "long"])
def test_caps_are_the_jax_packages_triangulations(lengths):
    """Every loop's cap equals the JAX package's DP triangulation of it,
    triangle for triangle and in order (loops over 48 points take another
    area formula there, which gives the same values)."""
    loops, verts = random_loops(len(lengths), lengths)
    caps = retopo._min_area_caps(np.concatenate(loops), np.asarray(lengths), verts)
    want = [np.asarray(jretopo._min_area_triangulation(loop, verts), np.int64).reshape(-1, 3)
            for loop in loops]
    np.testing.assert_array_equal(caps, np.concatenate(want))


def sheet_with_slivers(seed):
    """A flat 12 x 12 sheet of quads with some triangles taken out: holes
    of 3 to 9 boundary edges, and the sheet's own rim on the domain box."""
    rng = np.random.default_rng(seed)
    n = 12
    y, x = np.mgrid[0:n + 1, 0:n + 1]
    verts = np.stack([x.ravel(), y.ravel(), rng.normal(0, 1e-3, x.size)], 1).astype(np.float32)
    faces = []
    for j in range(n):
        for i in range(n):
            a, b, c, d = j * (n + 1) + i, j * (n + 1) + i + 1, (j + 1) * (n + 1) + i + 1, (j + 1) * (n + 1) + i
            faces += [(a, b, c), (a, c, d)]
    faces = np.asarray(faces, np.int64)
    keep = np.ones(len(faces), bool)
    for cell in rng.choice(np.arange(1, n - 1) * n + 5, 6, replace=False):
        keep[2 * cell: 2 * cell + 2 * rng.integers(1, 3)] = False
    return verts, faces[keep]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stitched_sheet_is_the_jax_packages(seed):
    verts, faces = sheet_with_slivers(seed)
    lo, hi = np.array([0.0, 0.0, -1.0]), np.array([12.0, 12.0, 1.0])
    got_stats, want_stats = {}, {}
    got = retopo.stitch_boundary_loops(Mesh(verts, faces), lo, hi, 1e-3, stats=got_stats)
    want = jretopo.stitch_boundary_loops(JMesh(verts, faces), lo, hi, 1e-3, stats=want_stats)
    np.testing.assert_array_equal(got.faces, want.faces)
    assert got_stats == want_stats and got_stats["closed_loops"] > 0
    np.testing.assert_array_equal(retopo.boundary_edges(got), jretopo.boundary_edges(want))
    assert got.num_faces > faces.shape[0]


def test_design2_export_heals_as_the_jax_package_does(monkeypatch):
    """The welded mesh of Design2's adaptive export (octree 4 -> 6, grid 7,
    2 refine steps) retopologized and stitched by both packages: the same
    vertices and faces after each step."""
    seen = []

    def keep(mesh, lo, cell):
        seen.append((mesh, lo, cell))
        return retopo.retopologize(mesh, lo, cell)

    monkeypatch.setattr(adaptive, "retopologize", keep)
    scene = get_design("design2")
    config = dataclasses.replace(scene.export_config, minimum_octree_level=4,
                                 maximum_octree_level=6, grid_level=7, gradient_descent_steps=2)
    export_mesh(scene, config, autodetect_resolution=32, device="cpu")
    (mesh, lo, cell), = seen
    ours = retopo.retopologize(mesh, lo, cell)
    ref = jretopo.retopologize(JMesh(mesh.vertices, mesh.faces), lo, cell)
    np.testing.assert_array_equal(ours.faces, ref.faces)
    np.testing.assert_array_equal(ours.vertices, ref.vertices)
    assert ours.num_faces > mesh.num_faces  # the seams' triangles were split
    stats, jstats = {}, {}
    ours = retopo.stitch_boundary_loops(ours, lo, lo + 20.0, 1e-3, stats=stats)
    ref = jretopo.stitch_boundary_loops(ref, lo, lo + 20.0, 1e-3, stats=jstats)
    np.testing.assert_array_equal(ours.faces, ref.faces)
    assert stats == jstats and stats["closed_loops"] > 0
