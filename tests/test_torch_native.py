"""The port's native mesh ops (designcsg_tpu_torch/native, built with g++ at
first use) against its numpy paths and against the JAX package's native
library on the same inputs: equal bit for bit (tests/test_native.py's
cases)."""

import numpy as np
import pytest
import torch

from designcsg_tpu import native as jnative
from designcsg_tpu_torch import native
from designcsg_tpu_torch.export import writers
from designcsg_tpu_torch.ops.marching_cubes import _block_triangles, _slab_triangles, extract_surface


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


def _sphere(pts, r=1.0):
    return np.linalg.norm(pts, axis=-1) - r


def _corner_slab(res=32, z0=4, sz=6):
    r1 = res + 1
    axis = np.linspace(-1.5, 1.5, r1)
    zz, yy, xx = np.meshgrid(axis[z0 : z0 + sz + 1], axis, axis, indexing="ij")
    pts = np.stack([xx, yy, zz], axis=-1)
    return _sphere(pts.reshape(-1, 3)).reshape(sz + 1, r1, r1).astype(np.float32), res


def test_library_builds_into_the_build_directory():
    path = native._library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert not (native._SRC.parent / "libmeshops.so").exists()


@pytest.mark.parametrize("midpoint", [False, True])
def test_mc_slab_matches_numpy_and_jax(midpoint):
    vals, res = _corner_slab()
    keys_np, pos_np = _slab_triangles(vals, 4, res, midpoint)
    keys, pos = native.mc_slab(vals, 4, midpoint)
    np.testing.assert_array_equal(keys, keys_np)  # same traversal order
    np.testing.assert_allclose(pos, pos_np, atol=1e-6)
    jkeys, jpos = jnative.mc_slab(vals, 4, midpoint)
    np.testing.assert_array_equal(keys, jkeys)
    np.testing.assert_array_equal(pos, jpos)


def test_mc_blocks_matches_numpy_and_jax():
    rng = np.random.default_rng(3)
    k, b = 5, 4
    blocks = rng.uniform(-1, 1, size=(k, b + 1, b + 1, b + 1)).astype(np.float32)
    coords = (rng.integers(0, 12, size=(k, 3)) * 4).astype(np.int64)
    keys, pos = native.mc_blocks(blocks, coords, 64, False)
    ref = [_block_triangles(blocks[i], tuple(coords[i]), 64, False) for i in range(k)]
    np.testing.assert_array_equal(keys, np.concatenate([r[0] for r in ref]))
    np.testing.assert_allclose(pos, np.concatenate([r[1] for r in ref]), atol=1e-6)
    jkeys, jpos = jnative.mc_blocks(blocks, coords, 64, False)
    np.testing.assert_array_equal(keys, jkeys)
    np.testing.assert_array_equal(pos, jpos)


def test_cells_to_tri_keys_matches_numpy_and_jax():
    from designcsg_tpu_torch.export.compact import _cells_to_tri_keys_np

    rng = np.random.default_rng(4)
    cells = rng.integers(0, 16**3, 300).astype(np.int64)
    cfg = rng.integers(1, 255, 300).astype(np.uint8)
    keys = native.cells_to_tri_keys(cells, cfg, 16)
    np.testing.assert_array_equal(keys, _cells_to_tri_keys_np(cells, cfg, 16))
    np.testing.assert_array_equal(keys, jnative.cells_to_tri_keys(cells, cfg, 16))


def test_weld_matches_numpy_and_jax():
    keys = np.random.default_rng(0).integers(0, 500, size=10_000).astype(np.int64)
    num, inverse, first_idx = native.weld(keys)
    assert num == len(np.unique(keys))
    np.testing.assert_array_equal(keys[first_idx][inverse], keys)
    jnum, jinverse, jfirst = jnative.weld(keys)
    assert num == jnum
    np.testing.assert_array_equal(inverse, jinverse)
    np.testing.assert_array_equal(first_idx, jfirst)


def test_extract_native_equals_numpy():
    """The same triangle soup (vertex numbering differs: first appearance
    against sorted keys)."""
    mesh_np = extract_surface(_sphere, np.zeros(3), 1.5, 32, use_native=False)
    mesh_c = extract_surface(_sphere, np.zeros(3), 1.5, 32, use_native=True)
    np.testing.assert_array_equal(np.sort(mesh_c.triangle_soup().reshape(-1, 9), axis=0),
                                  np.sort(mesh_np.triangle_soup().reshape(-1, 9), axis=0))
    assert abs(mesh_c.signed_volume() - mesh_np.signed_volume()) < 1e-6


def test_native_stl_matches_python_writer_and_jax(tmp_path):
    from designcsg_tpu.export import writers as jwriters
    from designcsg_tpu.ops.marching_cubes import Mesh as JMesh

    mesh = extract_surface(_sphere, np.zeros(3), 1.5, 16, use_native=False)
    paths = [str(tmp_path / n) for n in ("native.stl", "python.stl", "jax.stl")]
    assert native.write_stl_soup(paths[0], mesh.triangle_soup()) == mesh.num_faces
    writers.write_stl(paths[1], mesh, header_text="x")  # the numpy writer
    jwriters.write_stl(paths[2], JMesh(vertices=mesh.vertices, faces=mesh.faces))
    data = [open(p, "rb").read() for p in paths]
    assert data[0][80:] == data[1][80:]
    assert data[0] == data[2]
