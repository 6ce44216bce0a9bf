"""Design2's adaptive export in the port against the JAX package's on the CPU,
at a small octree range with each package's own autodetect: the same
triangle set, per-level triangle counts and SDF evaluations, and zero
boundary edges (the case Design2's own 6 -> 8 configuration runs at full
size on the card, chip_smoke.py path C)."""

import dataclasses

import numpy as np
import pytest
import torch

import designs
from designcsg_tpu import native as jnative
from designcsg_tpu.export import pipeline as jpipeline
from designcsg_tpu_torch import native
from designcsg_tpu_torch.designs import get_design
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


def _keyed_faces(mesh):
    f = mesh.faces
    k = np.argmin(f, axis=1)
    rolled = np.stack([f[np.arange(len(f)), (k + i) % 3] for i in range(3)], 1)
    return rolled[np.lexsort(rolled.T[::-1])]


def test_design2_adaptive_export_matches_jax():
    """Octree 3 -> 5 at grid level 6, 2 refine steps, numpy welds on both
    sides: the same faces, vertices within 1e-4, the same per-level counts
    and evaluations, no open edge."""
    kw = dict(minimum_octree_level=3, maximum_octree_level=5, grid_level=6,
              gradient_descent_steps=2)
    jscene, tscene = designs.get_design("design2"), get_design("design2")
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
    assert tr.sdf_evals == jr.sdf_evals
    assert tm.num_faces == jm.num_faces > 1000
    np.testing.assert_array_equal(_keyed_faces(tm), _keyed_faces(jm))
    np.testing.assert_allclose(tm.vertices, jm.vertices, rtol=0, atol=1e-4)
    assert boundary_edges(tm).shape[0] == 0
