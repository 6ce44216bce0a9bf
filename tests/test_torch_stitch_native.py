"""The crack-loop stitch in native code (native/meshops.cpp ``stitch_loops``,
built with g++ at first use) against its numpy fallback in
export/retopo.py: the same faces, in the same order, and the same
``open_loops`` and ``closed_loops``, on sliver sheets, fans over random
near-planar loops with equal-cost ties, loops longer than ``max_loop``,
loops on the domain box, a closed mesh and the mesh a multi-level Design2
export stitches."""

import contextlib
import dataclasses
import logging

import numpy as np
import pytest
import torch

from designcsg_tpu_torch import native
from designcsg_tpu_torch.designs import get_design
from designcsg_tpu_torch.export import adaptive, retopo
from designcsg_tpu_torch.export.pipeline import export_mesh
from designcsg_tpu_torch.ops.marching_cubes import Mesh
from test_torch_mesh_ops import random_loops, sheet_with_slivers


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the suite runs one process per
    worker, and a default-sized thread pool in each oversubscribes the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _built():
    if not native.available():
        pytest.skip("no host C++ compiler (g++) to build native/meshops.cpp")


@contextlib.contextmanager
def without_native():
    """The numpy fallback, as a host without a C++ compiler runs it."""
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(native, "available", lambda: False)
        yield


def both(mesh, *args, **kwargs):
    """The stitch on both paths, held equal: returns the native result and
    its stats."""
    got_stats, want_stats = {}, {}
    got = retopo.stitch_boundary_loops(mesh, *args, stats=got_stats, **kwargs)
    with without_native():
        want = retopo.stitch_boundary_loops(mesh, *args, stats=want_stats, **kwargs)
    np.testing.assert_array_equal(got.faces, want.faces)
    assert got.faces.dtype == want.faces.dtype
    assert got.vertices is mesh.vertices and want.vertices is mesh.vertices
    assert got_stats == want_stats
    return got, got_stats


def fans(loops, verts):
    """A fan from an apex above each loop to its edges: each loop is then
    one hole of the mesh, walked from its first vertex."""
    faces, apexes = [], []
    for loop in loops:
        apex = verts.shape[0] + len(apexes)
        pts = verts[loop].astype(np.float64)
        apexes.append(pts.mean(0) + [0.0, 0.0, np.ptp(pts[:, 0]) + 0.1])
        faces += [(a, b, apex) for a, b in zip(loop, np.roll(loop, -1))]
    verts = np.concatenate([verts, np.asarray(apexes, np.float32)])
    return Mesh(verts, np.asarray(faces, np.int64))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sliver_sheets(seed):
    verts, faces = sheet_with_slivers(seed)
    lo, hi = np.array([0.0, 0.0, -1.0]), np.array([12.0, 12.0, 1.0])
    got, stats = both(Mesh(verts, faces), lo, hi, 1e-3)
    assert stats["closed_loops"] > 0 and got.num_faces > faces.shape[0]
    # The sheet's rim lies on the domain box and is left open.
    assert retopo.boundary_edges(got).shape[0] == 4 * 12


def test_faces_with_a_repeated_vertex_are_dropped():
    """Faces given with a repeated vertex leave with the stitch's output on
    both paths (the native caps come without such faces)."""
    verts, faces = sheet_with_slivers(3)
    faces[[5, 40, 41], 1] = faces[[5, 40, 41], 0]
    faces[77, 2] = faces[77, 1]
    got, stats = both(Mesh(verts, faces))
    assert stats["closed_loops"] > 0
    f = got.faces
    assert ((f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])).all()


@pytest.mark.parametrize("seed", [3, 4, 5, 6])
def test_loops_of_every_length_with_ties(seed):
    """Loops of 3 to 64 points (some with a repeated point, whose zero-area
    triangles tie) each capped as the numpy DP caps it."""
    lengths = list(range(3, 65))
    loops, verts = random_loops(seed, lengths)
    got, stats = both(fans(loops, verts))
    assert stats == {"open_loops": 0, "closed_loops": len(lengths)}
    assert got.num_faces == sum(lengths) + sum(m - 2 for m in lengths)


@pytest.mark.parametrize("a,b", [(1, 1), (2, 3), (5, 7), (12, 12), (10, 22)])
def test_lattice_loops_tie_everywhere(a, b):
    """A loop of the integer lattice's points around an a x b rectangle
    (4 to 64 points): its collinear runs give zero-area triangles and its
    areas are exact halves, so most splits tie and the first of equal cost
    decides."""
    rim = ([(x, 0) for x in range(a)] + [(a, y) for y in range(b)]
           + [(a - x, b) for x in range(a)] + [(0, b - y) for y in range(b)])
    verts = np.asarray([(x, y, 0.0) for x, y in rim], np.float32)
    got, stats = both(fans([list(range(len(rim)))], verts))
    assert stats["closed_loops"] == 1 and got.num_faces == 2 * len(rim) - 2


@pytest.mark.parametrize("max_loop", [64, 20, 7])
def test_loops_longer_than_max_loop_stay_open(max_loop, caplog):
    """A loop past ``max_loop`` is abandoned where it passes it, counted
    and warned of; the walk goes on from the next unused edge, as the
    numpy walk does."""
    loops, verts = random_loops(7, [70, 5, 12, 33, 3])
    with caplog.at_level(logging.WARNING, logger="designcsg_tpu_torch"):
        _, stats = both(fans(loops, verts), max_loop=max_loop)
    assert stats["open_loops"] > 0
    warned = [r for r in caplog.records if "longer than %d" % max_loop in r.getMessage()]
    assert len(warned) == 2  # once a path


def test_loops_on_the_domain_box_stay_open():
    """A hole whose points all lie within ``eps`` of the box's faces is a
    clip boundary and stays open; one with a point off them is capped."""
    eps = 1e-3
    on = np.array([[0, 0, 0], [4, 0, 0], [4, 4, 0.0009], [0, 4, 0], [2, 5, 0]], np.float32)
    off = on.copy()
    off[4, 2] = 0.0011
    loops = [list(range(5)), list(range(5, 10))]
    mesh = fans(loops, np.concatenate([on, off]))
    lo, hi = np.array([0.0, 0.0, 0.0]), np.array([8.0, 8.0, 8.0])
    got, stats = both(mesh, lo, hi, eps)
    assert stats == {"open_loops": 0, "closed_loops": 1}
    assert got.num_faces == mesh.num_faces + 3
    got, stats = both(mesh)  # no box: both capped
    assert stats["closed_loops"] == 2


def test_closed_and_empty_meshes_come_back_as_they_were():
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    tetra = Mesh(verts, np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]], np.int64))
    empty = Mesh(verts, np.zeros((0, 3), np.int64))
    for mesh in (tetra, empty):
        stats = {}
        assert retopo.stitch_boundary_loops(mesh, stats=stats) is mesh
        with without_native():
            assert retopo.stitch_boundary_loops(mesh, stats=stats) is mesh
        assert stats == {}


def test_a_face_past_the_vertices_or_of_another_shape_is_refused():
    verts = np.zeros((3, 3), np.float32)
    with pytest.raises(IndexError):
        native.stitch_loops(np.array([[0, 1, 3]], np.int64), verts, None, None, 1e-6, 64)
    with pytest.raises(IndexError):
        native.stitch_loops(np.array([[0, -1, 2]], np.int64), verts, None, None, 1e-6, 64)
    with pytest.raises(ValueError):
        native.stitch_loops(np.array([0, 1, 2, 0], np.int64), verts, None, None, 1e-6, 64)


def test_the_native_pass_runs_where_it_builds_and_numpy_elsewhere(monkeypatch):
    """With the library built the native pass runs; without it the numpy
    walk and caps run alone, and close a four-point hole."""
    loops, verts = random_loops(8, [4])
    mesh = fans(loops, verts)
    calls, stitch = [], native.stitch_loops
    monkeypatch.setattr(native, "stitch_loops", lambda *a: calls.append(a) or stitch(*a))
    retopo.stitch_boundary_loops(mesh)
    assert len(calls) == 1
    stats = {}
    with without_native():
        out = retopo.stitch_boundary_loops(mesh, stats=stats)
    assert len(calls) == 1
    assert stats == {"open_loops": 0, "closed_loops": 1} and out.num_faces == 6
    assert retopo.boundary_edges(out).shape[0] == 0


def test_design2_export_mesh(monkeypatch):
    """The welded and retopologized mesh of Design2's adaptive export
    (octree 4 -> 6, grid 7, 2 refine steps), stitched on both paths with
    the export's own box and tolerance."""
    seen = []

    def keep(mesh, **kwargs):
        seen.append((mesh, kwargs))
        return retopo.stitch_boundary_loops(mesh, **kwargs)

    monkeypatch.setattr(adaptive, "stitch_boundary_loops", keep)
    scene = get_design("design2")
    config = dataclasses.replace(scene.export_config, minimum_octree_level=4,
                                 maximum_octree_level=6, grid_level=7, gradient_descent_steps=2)
    export_mesh(scene, config, autodetect_resolution=32, device="cpu")
    (mesh, kwargs), = seen
    kwargs.pop("stats")
    got, stats = both(mesh, **kwargs)
    assert stats["closed_loops"] > 0 and stats["open_loops"] == 0
    assert retopo.boundary_edges(got).shape[0] == 0
