"""The active-block and compact extractions of the port (export/active.py,
export/compact.py) on the CPU: against the port's dense path, against each
other, and against the JAX package's on Design1 (tests/test_active.py and
tests/test_compact.py's cases, less the sharded one, which comes with
multi-device support).

Meshes are compared as triangle sets: with the numpy weld, a vertex's index
is the rank of its lattice edge key, so two meshes of one key set have the
same vertex numbering, and their faces (each rotated to start at its least
index, keeping the winding) sort into equal rows.
"""

import dataclasses

import numpy as np
import pytest
import torch

import designs
from designcsg_tpu import native as jnative
from designcsg_tpu.evaluator import BatchEvaluator as JBatchEvaluator
from designcsg_tpu.export import active as jactive
from designcsg_tpu.export import compact as jcompact
from designcsg_tpu.export import pipeline as jpipeline
from designcsg_tpu_torch import native
from designcsg_tpu_torch.designs import get_design
from designcsg_tpu_torch.evaluator import BatchEvaluator
from designcsg_tpu_torch.export import compact as tcompact
from designcsg_tpu_torch.export import pipeline as tpipeline
from designcsg_tpu_torch.export.active import (
    block_mask,
    choose_block,
    extract_surface_active,
    gather_blocks,
    make_slab_provider,
)
from designcsg_tpu_torch.export.compact import assemble_from_compact, extract_surface_compact
from designcsg_tpu_torch.ops.marching_cubes import extract_surface


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the suite runs one process per
    worker, and a default-sized thread pool in each oversubscribes the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def evaluator():
    return BatchEvaluator(get_design("design1"), device="cpu")


def keyed_faces(mesh):
    """Faces rotated to start at their least vertex index (winding kept),
    rows sorted: equal for two meshes of one triangle set welded by key."""
    f = mesh.faces
    k = np.argmin(f, axis=1)
    rolled = np.stack([f[np.arange(len(f)), (k + i) % 3] for i in range(3)], 1)
    return rolled[np.lexsort(rolled.T[::-1])]


def assert_same_triangles(a, b, atol=0.0):
    """One triangle set: the same vertex keys, the same faces, vertex
    positions within ``atol`` (numpy-welded meshes)."""
    assert a.num_faces == b.num_faces > 0 and a.num_vertices == b.num_vertices
    np.testing.assert_array_equal(keyed_faces(a), keyed_faces(b))
    np.testing.assert_allclose(a.vertices, b.vertices, rtol=0, atol=atol)


def test_active_matches_dense(evaluator):
    """Same cells, corner values and table: the dense path on host-built
    points (float64 lattice, rounded once) and the active path on the
    device lattice (a float32 product and sum) agree within an ulp of the
    corner values."""
    dense = extract_surface(evaluator.eval_sdf_at_points, np.zeros(3), 2.0, 64, slab_cells=32,
                            use_native=False)
    active = extract_surface_active(evaluator, np.zeros(3), 2.0, 64, slab_cells=32, use_native=False)
    assert_same_triangles(dense, active, atol=1e-5)


def test_active_numpy_host_matches_native(evaluator):
    a = extract_surface_active(evaluator, np.zeros(3), 2.0, 32, slab_cells=32, use_native=True)
    b = extract_surface_active(evaluator, np.zeros(3), 2.0, 32, slab_cells=32, use_native=False)
    np.testing.assert_array_equal(np.sort(a.triangle_soup().reshape(-1, 9), axis=0),
                                  np.sort(b.triangle_soup().reshape(-1, 9), axis=0))


def test_block_mask_flags_exactly_the_sign_change_blocks():
    r1 = 17
    coords = np.linspace(-1.0, 1.0, r1)
    g = np.stack(np.meshgrid(coords, coords, coords, indexing="ij"), axis=-1)
    vals = torch.from_numpy(np.linalg.norm(g, axis=-1).astype(np.float32) - 0.5)
    mask = block_mask(vals, 8, 8, 8)
    assert mask.shape == (2, 2, 2) and bool(mask.all())
    assert not bool(block_mask(vals + 10.0, 8, 8, 8).any())
    # Random fields: a block is flagged iff one of its cells' 8 corners
    # straddle zero (min < 0 <= max), checked cell by cell.
    rng = np.random.default_rng(1)
    v = rng.normal(1.8, 0.7, (9, 17, 17)).astype(np.float32)
    got = block_mask(torch.from_numpy(v), 4, 8, 4).numpy()
    want = np.zeros((2, 2, 4), bool)
    for z, y, x in np.ndindex(8, 16, 16):
        c = v[z : z + 2, y : y + 2, x : x + 2]
        want[z // 4, y // 8, x // 4] |= bool(c.min() < 0 <= c.max())
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


def test_gather_blocks_takes_the_corner_sub_grids():
    v = torch.arange(9 * 17 * 17, dtype=torch.float32).reshape(9, 17, 17)
    origins = torch.tensor([[0, 8, 4], [4, 0, 12]])
    got = gather_blocks(v, origins, 4, 8, 4)
    assert tuple(got.shape) == (2, 5, 9, 5)
    np.testing.assert_array_equal(got[0].numpy(), v[0:5, 8:17, 4:9].numpy())
    np.testing.assert_array_equal(got[1].numpy(), v[4:9, 0:9, 12:17].numpy())


def test_choose_block_divides():
    for res in (32, 64, 128, 512):
        for slab in (8, 16, 32):
            bz, by, bx = choose_block(res, slab)
            assert slab % bz == 0 and res % by == 0 and res % bx == 0
    assert choose_block(512, 32) == (4, 8, 8)
    bz, by, bx = choose_block(48, 12)
    assert 12 % bz == 0 and 48 % by == 0 and 48 % bx == 0


def test_any_block_gives_the_same_triangles(evaluator):
    a = extract_surface_active(evaluator, np.zeros(3), 2.0, 32, slab_cells=16, block=(16, 32, 32),
                               use_native=False)
    b = extract_surface_active(evaluator, np.zeros(3), 2.0, 32, slab_cells=16, block=(2, 4, 8),
                               use_native=False)
    assert_same_triangles(a, b)


def test_tape_provider_equals_kernel_field_provider():
    """On Design1 the kernels' field is the exact tape: the grid kernel's
    plain version and the plain tape on the device lattice give the same
    corner values."""
    scene = get_design("design1")
    lo = np.array([-2.1, -1.9, -2.0])
    a = make_slab_provider(BatchEvaluator(scene, device="cpu", use_kernels=True))(lo, 0.125, 3, 9, 33)
    b = make_slab_provider(BatchEvaluator(scene, device="cpu", chunk_size=1000))(lo, 0.125, 3, 9, 33)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.fixture(scope="module")
def jax_exports():
    """{strategy: (jax mesh, port mesh)} of Design1's export at grid level 5
    with a 32^3 autodetect, no refinement, both sides on their numpy welds."""
    jscene, tscene = designs.get_design("design1"), get_design("design1")
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "available", lambda: False)
    mp.setattr(native, "available", lambda: False)
    out = {}
    try:
        for strategy in ("dense", "active", "compact"):
            kw = dict(autodetect_resolution=32, strategy=strategy)
            jm, jr = jpipeline.export_mesh(jscene, dataclasses.replace(
                jscene.export_config, grid_level=5, gradient_descent_steps=0), **kw)
            tm, tr = tpipeline.export_mesh(tscene, dataclasses.replace(
                tscene.export_config, grid_level=5, gradient_descent_steps=0), device="cpu", **kw)
            out[strategy] = (jm, jr, tm, tr)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("strategy", ["dense", "active", "compact"])
def test_strategy_matches_jax(jax_exports, strategy):
    """The same faces on the same lattice keys; vertices within 1e-5 (the
    dense export's rule, tests/test_torch_export.py: corner values an ulp
    apart move an interpolated vertex by a few ulps of the box)."""
    jm, jr, tm, tr = jax_exports[strategy]
    assert_same_triangles(tm, jm, atol=1e-5)
    assert tr.sdf_evals == jr.sdf_evals and tr.stats["strategy"] == strategy
    assert tr.stats["native"] is False


def test_strategies_agree_in_the_port(jax_exports):
    dense = jax_exports["dense"][2]
    assert_same_triangles(jax_exports["active"][2], dense)
    assert_same_triangles(jax_exports["compact"][2], dense, atol=1e-6)


def test_compact_matches_dense_multislab(evaluator):
    """res 64, slab 16: the shared corner planes put x and y edge keys into
    two slabs' streams, which assembly dedupes."""
    dense = extract_surface_active(evaluator, np.zeros(3), 4.0, 64, slab_cells=16, use_native=False)
    compact = extract_surface_compact(evaluator, np.zeros(3), 4.0, 64, slab_cells=16, use_native=False)
    assert_same_triangles(compact, dense, atol=1e-6)


def test_compact_duplicate_edge_keys_exist(evaluator, monkeypatch):
    stream = {}
    orig = tcompact.assemble_from_compact

    def spy(cells_idx, cells_cfg, edge_keys, edge_t, *args, **kwargs):
        stream["keys"] = edge_keys
        return orig(cells_idx, cells_cfg, edge_keys, edge_t, *args, **kwargs)

    monkeypatch.setattr(tcompact, "assemble_from_compact", spy)
    stats = {}
    extract_surface_compact(evaluator, np.zeros(3), 4.0, 32, slab_cells=8, stats=stats)
    assert stream["keys"].size > np.unique(stream["keys"]).size
    assert sum(stats["slab_cells_active"].values()) > 0


def test_compact_matches_active_both_backends(evaluator):
    active = extract_surface_active(evaluator, np.zeros(3), 2.0, 32, slab_cells=16, use_native=False)
    for use_native in (True, False):
        compact = extract_surface_compact(evaluator, np.zeros(3), 2.0, 32, slab_cells=16,
                                          use_native=use_native)
        np.testing.assert_allclose(np.sort(compact.triangle_soup().reshape(-1, 9), axis=0),
                                   np.sort(active.triangle_soup().reshape(-1, 9), axis=0), atol=1e-6)


def test_compact_midpoint_mode_matches_jax(evaluator):
    jev = JBatchEvaluator(designs.get_design("design1"))
    lo = np.array([0.0371, -0.0287, 0.0113])
    ours = extract_surface_compact(evaluator, lo, 2.0, 32, midpoint=True, use_native=False)
    ref = jcompact.extract_surface_compact(jev, lo, 2.0, 32, midpoint=True, use_native=False)
    assert_same_triangles(ours, ref, atol=1e-6)  # midpoints: no interpolation
    dense = extract_surface(evaluator.eval_sdf_at_points, lo, 2.0, 32, midpoint=True, use_native=False)
    assert ours.num_faces == dense.num_faces


def test_active_on_an_offset_box_matches_jax(evaluator):
    """The active extraction itself against JAX's, blocks and all, off the
    autodetect path."""
    jev = JBatchEvaluator(designs.get_design("design1"))
    center = np.array([0.0371, -0.0287, 0.0113])
    ours = extract_surface_active(evaluator, center, 2.0, 32, slab_cells=16, use_native=False)
    ref = jactive.extract_surface_active(jev, center, 2.0, 32, slab_cells=16, use_native=False)
    assert_same_triangles(ours, ref, atol=1e-5)


def test_compact_empty_volume(evaluator):
    mesh = extract_surface_compact(evaluator, np.array([50.0, 50.0, 50.0]), 1.0, 16)
    assert mesh.num_faces == 0 and mesh.num_vertices == 0


def test_assemble_missing_edge_raises():
    r1 = 5
    keys = [((axis * r1 + 0) * r1 + 0) * r1 + 0 for axis in (0, 1, 2)]
    with pytest.raises(AssertionError, match="missing from the compacted"):
        assemble_from_compact(np.array([0], np.int64), np.array([1], np.uint8),
                              np.array(keys[:2], np.int64), np.full(2, 0.5, np.float32), 4,
                              np.zeros(3), 0.25, use_native=False)


def test_compact_bytes_shipped_accounting(evaluator, monkeypatch):
    captured = {}
    orig = tcompact.assemble_from_compact

    def spy(cells_idx, cells_cfg, edge_keys, edge_t, *args, **kwargs):
        captured["bytes"] = cells_idx.nbytes + cells_cfg.nbytes + edge_keys.nbytes + edge_t.nbytes
        return orig(cells_idx, cells_cfg, edge_keys, edge_t, *args, **kwargs)

    monkeypatch.setattr(tcompact, "assemble_from_compact", spy)
    extract_surface_compact(evaluator, np.zeros(3), 2.0, 64, slab_cells=16)
    assert captured["bytes"] < 65 * 65 * 65 * 4 / 3


def test_active_resume_reuses_slabs(tmp_path):
    scene = get_design("design1")
    cfg = dataclasses.replace(scene.export_config, grid_level=4, gradient_descent_steps=1)
    for strategy in ("active", "compact"):
        kw = dict(export_config=cfg, autodetect_resolution=16, strategy=strategy, device="cpu",
                  resume_dir=str(tmp_path / strategy), slab_cells=8)
        m1, _ = tpipeline.export_mesh(scene, **kw)
        import glob
        import os

        for path in glob.glob(str(tmp_path / strategy / "extract_*.npz")):
            os.remove(path)  # keep the slab shards only
        m2, r2 = tpipeline.export_mesh(scene, **kw)
        np.testing.assert_array_equal(m1.faces, m2.faces)
        np.testing.assert_array_equal(m1.vertices, m2.vertices)
