"""The port's retopology (designcsg_tpu_torch/export/retopo.py, a numpy copy
of the JAX package's): tests/test_retopo.py's cases on the port's functions,
and the two packages' outputs equal on the same meshes."""

import numpy as np
import pytest
import torch

from designcsg_tpu.export import retopo as jretopo
from designcsg_tpu.ops.marching_cubes import Mesh as JMesh
from designcsg_tpu_torch.export.retopo import merge_meshes, retopologize, strip_triangulate
from designcsg_tpu_torch.ops.marching_cubes import Mesh


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the suite runs one process per
    worker, and a default-sized thread pool in each oversubscribes the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def edge_face_counts(faces):
    counts = {}
    for f in faces:
        for i in range(3):
            e = tuple(sorted((int(f[i]), int(f[(i + 1) % 3]))))
            counts[e] = counts.get(e, 0) + 1
    return counts


def test_strip_triangulate_square():
    tris = strip_triangulate([0, 1, 2, 3])
    assert len(tris) == 2
    # Winding preserved: both triangle normals point the same way for a
    # planar CCW square.
    quad = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], float)
    for t in tris:
        a, b, c = (quad[i] for i in t)
        assert np.cross(b - a, c - a)[2] > 0


def test_strip_triangulate_pentagon_covers_area():
    ang = np.linspace(0, 2 * np.pi, 5, endpoint=False)
    poly = np.stack([np.cos(ang), np.sin(ang), np.zeros(5)], axis=-1)
    tris = strip_triangulate(list(range(5)))
    assert len(tris) == 3
    area = sum(
        0.5 * np.linalg.norm(np.cross(poly[b] - poly[a], poly[c] - poly[a]))
        for a, b, c in tris
    )
    exact = 0.5 * 5 * np.sin(2 * np.pi / 5)
    np.testing.assert_allclose(area, exact, rtol=1e-6)


def test_t_junction_heals():
    # Coarse triangle (0-1-2) whose edge 0-1 passes through lattice point
    # (1,0,0); the fine side has a vertex there (id 3).  Before healing the
    # edge (0,1) borders one face while the fine side borders (0,3)/(3,1) —
    # a crack.  After retopologize the coarse triangle is split at vertex 3
    # and every interior edge is shared by exactly 2 faces.
    verts = np.array(
        [
            [0, 0, 0],  # 0
            [2, 0, 0],  # 1
            [1, 1, 0],  # 2 coarse apex
            [1, 0, 0],  # 3 fine mid vertex ON the coarse edge
            [0, -1, 0],  # 4
            [2, -1, 0],  # 5
        ],
        dtype=np.float32,
    )
    faces = np.array([[0, 1, 2], [0, 3, 4], [3, 5, 4], [3, 1, 5]], dtype=np.int64)
    mesh = Mesh(verts, faces)
    before = edge_face_counts(faces)
    assert before[(0, 1)] == 1 and before[(0, 3)] == 1  # the crack

    healed = retopologize(mesh, np.zeros(3), 1.0)
    counts = edge_face_counts(healed.faces)
    assert (0, 1) not in counts  # coarse edge split at vertex 3
    assert counts[(0, 3)] == 2 and counts[(1, 3)] == 2  # crack healed
    # Area preserved.
    assert abs(Mesh(healed.vertices, healed.faces).surface_area() - 3.0) < 1e-5


def test_t_junction_two_interior_points():
    # Coarse edge spanning 3 fine cells with two occupied interior points.
    verts = np.array(
        [
            [0, 0, 0],
            [3, 0, 0],
            [1.5, 2, 0],
            [1, 0, 0],
            [2, 0, 0],
            [1.5, -1, 0],
        ],
        dtype=np.float32,
    )
    faces = np.array([[0, 1, 2], [0, 3, 5], [3, 4, 5], [4, 1, 5]], dtype=np.int64)
    healed = retopologize(Mesh(verts, faces), np.zeros(3), 0.5)
    counts = edge_face_counts(healed.faces)
    assert (0, 1) not in counts
    assert counts[(0, 3)] == 2 and counts[(3, 4)] == 2 and counts[(1, 4)] == 2


def test_merge_meshes_welds_shared_boundary():
    v1 = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    v2 = np.array([[1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    merged = merge_meshes(
        [Mesh(v1, np.array([[0, 1, 2]])), Mesh(v2, np.array([[0, 1, 2]]))]
    )
    assert merged.num_vertices == 4  # shared edge vertices welded
    assert merged.num_faces == 2
    counts = edge_face_counts(merged.faces)
    shared = [e for e, c in counts.items() if c == 2]
    assert len(shared) == 1


def test_retopologize_noop_on_uniform_mesh():
    # A crack-free closed mesh passes through unchanged up to triangle count
    # (every edge already manifold; no lattice points to insert).
    from designcsg_tpu_torch.designs import get_design
    from designcsg_tpu_torch.evaluator import BatchEvaluator
    from designcsg_tpu_torch.ops.marching_cubes import extract_surface

    ev = BatchEvaluator(get_design("design1"), device="cpu")
    mesh = extract_surface(
        ev.eval_sdf_at_points, np.zeros(3), 2.0, 16, midpoint=True
    )
    healed = retopologize(mesh, np.zeros(3) - 2.0, 4.0 / 32)
    assert healed.num_faces == mesh.num_faces
    assert abs(healed.surface_area() - mesh.surface_area()) < 1e-4


def test_boundary_edges_and_stitch_loops():
    """A square hole in a flat sheet: boundary_edges finds its 4 directed
    edges; stitch_boundary_loops caps it with consistently wound triangles."""
    from designcsg_tpu_torch.export.retopo import boundary_edges, stitch_boundary_loops

    # 4x4 vertex sheet (z=0), 18 triangles, minus the 2 covering the center
    # cell -> a square hole bounded by verts 5, 6, 10, 9.
    xs, ys = np.meshgrid(np.arange(4.0), np.arange(4.0), indexing="xy")
    verts = np.stack([xs.ravel(), ys.ravel(), np.zeros(16)], axis=-1)
    faces = []
    for j in range(3):
        for i in range(3):
            if (i, j) == (1, 1):
                continue
            a = j * 4 + i
            faces.append((a, a + 1, a + 5))
            faces.append((a, a + 5, a + 4))
    mesh = Mesh(vertices=verts, faces=np.asarray(faces, np.int64))
    be = boundary_edges(mesh)
    hole = {tuple(sorted(e)) for e in be if set(e) <= {5, 6, 10, 9}}
    assert len(hole) == 4

    stitched = stitch_boundary_loops(mesh)
    sbe = boundary_edges(stitched)
    # Hole capped; the sheet's outer rim touches nothing else and stays open
    # only if it exceeds max_loop -- here it's 12 edges, so it caps too.
    assert not any(set(e) <= {5, 6, 10, 9} for e in sbe)
    # The hole-cap faces wind consistently with the sheet (+z normals).
    added = stitched.faces[mesh.faces.shape[0] :]
    caps = [t for t in added if set(map(int, t)) <= {5, 6, 9, 10}]
    assert len(caps) == 2
    for t in caps:
        a, b, c = verts[t[0]], verts[t[1]], verts[t[2]]
        assert np.cross(b - a, c - a)[2] > 0


def test_stitch_skips_domain_boundary():
    """An open boundary lying on the domain box is a clip edge, not a crack:
    left open."""
    from designcsg_tpu_torch.export.retopo import boundary_edges, stitch_boundary_loops

    verts = np.array(
        [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], dtype=np.float64
    )
    faces = np.array([[0, 1, 2], [0, 2, 3]], dtype=np.int64)
    mesh = Mesh(vertices=verts, faces=faces)
    out = stitch_boundary_loops(
        mesh, domain_lo=np.zeros(3), domain_hi=np.array([1.0, 1.0, 2.0])
    )
    assert out.num_faces == 2  # all boundary verts on the z=0 face... but
    # z=0 == domain_lo[2], so the whole loop sits on the domain box.
    assert boundary_edges(out).shape[0] == 4


def _cracked_mesh():
    """A coarse strip beside a fine one: T-junctions on the shared seam, and
    a hole in the fine strip."""
    xs, ys = np.meshgrid(np.arange(0.0, 5.0), np.arange(2.0, 5.0), indexing="xy")
    fine = np.stack([xs.ravel(), ys.ravel(), np.zeros(xs.size)], -1)
    coarse = np.array([[0, 0, 0], [2, 0, 0], [4, 0, 0], [0, 2, 0], [2, 2, 0], [4, 2, 0]], float)
    verts = np.concatenate([coarse, fine])
    faces = [(0, 1, 4), (0, 4, 3), (1, 2, 5), (1, 5, 4)]
    for j in range(2):
        for i in range(4):
            if (i, j) == (2, 1):
                continue
            a = 6 + j * 5 + i
            faces += [(a, a + 1, a + 6), (a, a + 6, a + 5)]
    return verts.astype(np.float32), np.asarray(faces, np.int64)


def test_retopo_and_stitch_equal_jax():
    verts, faces = _cracked_mesh()
    ours = retopologize(Mesh(verts, faces), np.zeros(3), 1.0)
    ref = jretopo.retopologize(JMesh(verts, faces), np.zeros(3), 1.0)
    np.testing.assert_array_equal(ours.faces, ref.faces)
    np.testing.assert_array_equal(ours.vertices, ref.vertices)
    assert ours.num_faces > faces.shape[0]
    from designcsg_tpu_torch.export.retopo import boundary_edges, stitch_boundary_loops

    stats, jstats = {}, {}
    ours = stitch_boundary_loops(ours, stats=stats)
    ref = jretopo.stitch_boundary_loops(ref, stats=jstats)
    np.testing.assert_array_equal(ours.faces, ref.faces)
    np.testing.assert_array_equal(boundary_edges(ours), jretopo.boundary_edges(ref))
    assert stats == jstats and stats["closed_loops"] > 0
