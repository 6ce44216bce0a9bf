"""The adaptive sweep's level steps on the evaluator's device
(export/adaptive.py ``_complex_cells``, ``_ambiguous_edges``,
``_canonical_offsets`` and ``_emit_cells`` on torch tensors) against the JAX
package's numpy helpers (``_edge_angles`` and the three others of the same
names), bit for bit: on the CPU, on the same surface cells, sign bits,
normals and evaluator, at fine-lattice scales 1, 2 and 4, over all 254 sign
configurations that straddle the surface and around the complexity
threshold's cut.

The card's case cannot import the JAX package, so it holds the card's
levels to ``_np_*`` below, the host emission the sweep ran before it moved
to the device; the CPU cases hold that copy to the JAX package's helpers
too.  Run it with the ``cuda`` marker:
``python -m pytest tests/test_torch_adaptive_emit.py -m cuda --noconftest -o addopts="" -p no:cacheprovider -q``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from designcsg_tpu_torch import native
from designcsg_tpu_torch.designs import get_design
from designcsg_tpu_torch.evaluator import BatchEvaluator
from designcsg_tpu_torch.export import adaptive
from designcsg_tpu_torch.export.pipeline import export_mesh
from designcsg_tpu_torch.observability import to_host
from designcsg_tpu_torch.ops.marching_cubes import (
    CORNERS,
    EDGE_AXIS,
    EDGE_ORIGIN,
    EDGES,
    triangle_table,
)

# A box off Design1's faces (tests/test_torch_adaptive_device.py), cells at
# level 4 of it; the fine lattice lies ``scale`` times finer.
LO = np.array([-10.0371, -9.9713, -10.0119])
HALF = 10.0
LEVEL = 4
# Interior samples an edge at each scale, as the sweep takes them with a
# grid one level below the finest: min(2 * scale - 1, 7).
SAMPLES = {1: 1, 2: 3, 4: 7}


def _np_canonical_offsets(evaluator, cells, vals, scale, lo, fine_cell):
    M = cells.shape[0]
    offs = np.full((M, 12), 0.5 * scale, dtype=np.float32)
    if M == 0 or scale == 1:
        if scale == 1:
            offs[:] = 0.5
        return offs
    inside = vals < 0.0
    cut = inside[:, EDGES[:, 0]] != inside[:, EDGES[:, 1]]
    if not cut.any():
        return offs
    sel = np.nonzero(cut)
    orig_fine = (cells[:, None, :] + EDGE_ORIGIN[None, :, :]) * scale
    axis = np.broadcast_to(EDGE_AXIS[None, :], (M, 12))
    nf = 1 << 20
    key = (
        (axis.astype(np.int64) * nf + orig_fine[..., 2]) * nf + orig_fine[..., 1]
    ) * nf + orig_fine[..., 0]
    ukeys, inv = np.unique(key[sel], return_inverse=True)
    uaxis = ukeys // (nf * nf * nf)
    rem = ukeys % (nf * nf * nf)
    uorig = np.stack([rem % nf, (rem // nf) % nf, rem // (nf * nf)], axis=-1)
    steps = np.arange(scale + 1, dtype=np.int64)
    unit = np.eye(3, dtype=np.int64)[uaxis]
    pts_fine = uorig[:, None, :] + steps[None, :, None] * unit[:, None, :]
    v = to_host(evaluator.eval_sdf_at_lattice(pts_fine.reshape(-1, 3), lo, fine_cell)).reshape(
        -1, scale + 1)
    s = v < 0.0
    trans = s[:, 1:] != s[:, :-1]
    first = np.where(trans.any(axis=1), trans.argmax(axis=1), scale // 2)
    offs[sel] = (first[inv] + 0.5).astype(np.float32)
    return offs


def _np_emit_cells(cells, vals, offs, scale, fine_res):
    tri_edges, n_tris = triangle_table()
    inside = vals < 0.0
    cfg = (inside.astype(np.int64) << np.arange(8)[None, :]).sum(axis=1)
    counts = n_tris[cfg]
    if int(counts.sum()) == 0:
        return np.zeros((0, 3), np.int64), np.zeros((0, 3, 3), np.float32)
    tri_cell = np.repeat(np.arange(cells.shape[0]), counts)
    slot = np.concatenate([np.arange(c) for c in counts if c])
    edges = tri_edges[cfg[tri_cell], slot]
    axis = EDGE_AXIS[edges]
    base = (cells[tri_cell][:, None, :] + EDGE_ORIGIN[edges]) * scale
    off = offs[tri_cell[:, None], edges]
    pos = base.astype(np.float32) + off[..., None] * np.eye(3, dtype=np.float32)[axis]
    pos2 = np.round(pos * 2.0).astype(np.int64)
    n2 = 2 * (fine_res + 1) + 2
    return (pos2[..., 2] * n2 + pos2[..., 1]) * n2 + pos2[..., 0], pos


def _np_edge_angles(normals):
    n0 = normals[:, EDGES[:, 0], :]
    n1 = normals[:, EDGES[:, 1], :]
    angles = np.arccos(np.clip((n0 * n1).sum(axis=-1), -1.0, 1.0))
    return np.where(np.isnan(angles), np.pi, angles).max(axis=1)


def _np_ambiguous_edges(evaluator, cells, vals, lo, cellsize, samples_per_edge):
    C = cells.shape[0]
    if C == 0 or samples_per_edge <= 0:
        return np.zeros((C,), bool)
    corner_pos = cells[:, None, :] + CORNERS[None, :, :]
    a = corner_pos[:, EDGES[:, 0], :]
    b = corner_pos[:, EDGES[:, 1], :]
    m = samples_per_edge + 1
    ks = np.arange(1, samples_per_edge + 1)
    idx = a[:, :, None, :] * m + (b - a)[:, :, None, :] * ks[None, None, :, None]
    interior = to_host(evaluator.eval_sdf_at_lattice(idx.reshape(-1, 3), lo, cellsize / m)).reshape(
        C, 12, samples_per_edge)
    sign_a = vals[:, EDGES[:, 0], None] < 0.0
    sign_b = vals[:, EDGES[:, 1], None] < 0.0
    seq = np.concatenate([sign_a, interior < 0.0, sign_b], axis=2)
    transitions = (seq[:, :, 1:] != seq[:, :, :-1]).sum(axis=2)
    implied = (sign_a[:, :, 0] != sign_b[:, :, 0]).astype(np.int64)
    return (transitions > implied).any(axis=1)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the suite runs one process per
    worker, and a default-sized thread pool in each oversubscribes the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _HostValues:
    """The port's evaluator as the JAX package's numpy helpers call it: its
    lattice values brought to the host, its evaluations counted on it."""

    def __init__(self, ev):
        self.ev = ev

    def eval_sdf_at_lattice(self, *args):
        return to_host(self.ev.eval_sdf_at_lattice(*args))


@pytest.fixture(scope="module")
def jax_helpers():
    """The JAX package's adaptive module, imported here: the card's case
    runs where JAX is absent."""
    from designcsg_tpu.export import adaptive as jax_adaptive

    return jax_adaptive


@pytest.fixture(scope="module")
def surface():
    """Design1's surface cells at level 4 of the box with their own sign
    bytes, then 254 of them again with the sign bytes 1..254, one each:
    (evaluator, cells i64[M, 3], signs u8[M])."""
    ev = BatchEvaluator(get_design("design1"), device="cpu")
    r = np.arange(1 << LEVEL)
    gz, gy, gx = np.meshgrid(r, r, r, indexing="ij")
    grid = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.int64)
    cellsize = 2.0 * HALF / (1 << LEVEL)
    signs = to_host(ev.eval_corner_signs_near(grid, LO, cellsize, CORNERS, 1.0)[0])
    real = np.nonzero((signs != 0) & (signs != 255))[0]
    assert 100 < real.size < grid.shape[0] // 4
    every = real[np.arange(254) % real.size]
    cells = np.concatenate([grid[real], grid[every]])
    signs = np.concatenate([signs[real], np.arange(1, 255, dtype=np.uint8)])
    return ev, cells, signs


def _vals(signs):
    """The host helpers' ±1 corner values of the sign bytes."""
    inside = (signs[:, None] >> np.arange(8, dtype=np.uint8)) & 1
    return np.where(inside.astype(bool), np.float32(-1.0), np.float32(1.0))


def _on_device(cells, signs):
    """The sweep's device form of the cells and their sign bytes."""
    return torch.as_tensor(cells.astype(np.int32)), torch.as_tensor(signs)


def _geometry(scale):
    max_level = LEVEL + scale.bit_length() - 1
    return 2.0 * HALF / (1 << LEVEL), 2.0 * HALF / (1 << max_level), 1 << max_level


def _bits(a):
    """An array's bytes, for a comparison that tells -0.0 from 0.0."""
    return np.ascontiguousarray(a).view(np.uint8)


def _counted(ev, fn, *args):
    before = ev.sdf_eval_count
    out = fn(*args)
    return out, ev.sdf_eval_count - before


@pytest.mark.parametrize("scale", [1, 2, 4])
def test_canonical_offsets_equal_the_numpy_helpers(surface, jax_helpers, scale):
    ev, cells, signs = surface
    _, fine_cell, _ = _geometry(scale)
    vals = _vals(signs)
    want, want_n = _counted(ev, jax_helpers._canonical_offsets, _HostValues(ev), cells, vals,
                            scale, LO, fine_cell)
    got, got_n = _counted(ev, adaptive._canonical_offsets, ev, adaptive._tables("cpu"),
                          *_on_device(cells, signs), scale, LO, fine_cell)
    assert got.dtype == torch.float32 and got_n == want_n
    assert np.array_equal(_bits(got.numpy()), _bits(want))
    copy = _np_canonical_offsets(ev, cells, vals, scale, LO, fine_cell)
    assert np.array_equal(_bits(copy), _bits(want))
    if scale > 1:  # some cut edge's vertex leaves the midpoint
        assert got_n > 0 and (want != 0.5 * scale).any()


@pytest.mark.parametrize("scale", [1, 2, 4])
def test_emitted_triangles_equal_the_numpy_helpers(surface, jax_helpers, scale):
    ev, cells, signs = surface
    _, fine_cell, fine_res = _geometry(scale)
    vals = _vals(signs)
    offs = jax_helpers._canonical_offsets(_HostValues(ev), cells, vals, scale, LO, fine_cell)
    want_keys, want_pos = jax_helpers._emit_cells(cells, vals, offs, scale, fine_res)
    keys, pos = adaptive._emit_cells(adaptive._tables("cpu"), *_on_device(cells, signs),
                                     torch.as_tensor(offs), scale, fine_res)
    assert keys.dtype == torch.int64 and pos.dtype == torch.float32
    assert keys.shape[0] > cells.shape[0]  # every configuration emits
    np.testing.assert_array_equal(keys.numpy(), want_keys)
    assert np.array_equal(_bits(pos.numpy()), _bits(want_pos))
    copy_keys, copy_pos = _np_emit_cells(cells, vals, offs, scale, fine_res)
    np.testing.assert_array_equal(copy_keys, want_keys)
    assert np.array_equal(_bits(copy_pos), _bits(want_pos))


def _near_cut_normals(threshold, ulps):
    """f32[N, 8, 3] unit corner normals whose edges from corner 1 make the
    float32 dot products ``ulps`` representable values either side of
    cos(threshold) (the other edges 0 rad), then one NaN normal."""
    c = np.float32(np.cos(threshold)).view(np.int32)
    d = (c + np.asarray(ulps, np.int32)).view(np.float32)
    normals = np.zeros((d.size + 1, 8, 3), np.float32)
    normals[:, :, 0] = 1.0
    normals[:-1, 1, 0] = d
    normals[:-1, 1, 1] = np.sqrt(1.0 - d.astype(np.float64) ** 2)
    normals[-1, 5] = np.nan
    return normals


@pytest.mark.parametrize("threshold", [0.6, np.pi / 4, 1.2])
def test_complexity_verdicts_equal_the_numpy_helpers(surface, jax_helpers, threshold):
    """The device test of the corner normals' angles against numpy's
    arccos on the same normals: the surface cells' own, and dot products
    at and around the cut, inside the table's window and beyond it."""
    ev, cells, _ = surface
    cellsize, _, _ = _geometry(1)
    ulps = np.r_[-5000:-4990, -1100:-1000, -40:41, 1000:1100, 4990:5000]
    normals = np.concatenate([to_host(ev.eval_normal_at_cell_corners(cells, LO, cellsize, CORNERS)),
                              _near_cut_normals(threshold, ulps)])
    want = jax_helpers._edge_angles(normals) > threshold
    got = adaptive._complex_cells(adaptive._tables("cpu"), torch.as_tensor(normals), threshold)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(_np_edge_angles(normals) > threshold, want)
    near = want[cells.shape[0]:-1]  # numpy's cut lies within a few values of cos
    assert near[ulps < -10].all() and not near[ulps > 10].any() and want[-1]
    assert (np.diff(near.astype(int)) <= 0).all()
    assert 0 < want[:cells.shape[0]].sum() < cells.shape[0]


@pytest.mark.parametrize("scale", [1, 2, 4])
def test_ambiguity_verdicts_equal_the_numpy_helpers(surface, jax_helpers, scale):
    ev, cells, signs = surface
    cellsize, _, _ = _geometry(scale)
    vals = _vals(signs)
    n = SAMPLES[scale]
    want, want_n = _counted(ev, jax_helpers._ambiguous_edges, _HostValues(ev), cells, vals, LO,
                            cellsize, n)
    got, got_n = _counted(ev, adaptive._ambiguous_edges, ev, adaptive._tables("cpu"),
                          *_on_device(cells, signs), LO, cellsize, n)
    assert got.dtype == torch.bool and got_n == want_n == cells.shape[0] * 12 * n
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(_np_ambiguous_edges(ev, cells, vals, LO, cellsize, n), want)
    assert 0 < want.sum() < want.size


@pytest.mark.parametrize("chunk", [1 << 20, 100])
@pytest.mark.parametrize("entry", ["sdf", "normal"])
def test_device_lattice_entry_points_equal_the_host_ones(surface, entry, chunk):
    """A lattice entry point given its cells as a host array and as an int32
    tensor on the device gives the same bits and counts the same, in one
    chunk or many, and the bits of one chunk."""
    one, cells, _ = surface
    ev = BatchEvaluator(get_design("design1"), device="cpu", chunk_size=chunk)
    cellsize, _, _ = _geometry(1)
    if entry == "sdf":
        idx = cells * 3 + 1
        args = (LO, cellsize / 3)
        call, one_call = ev.eval_sdf_at_lattice, one.eval_sdf_at_lattice
    else:
        idx = cells
        args = (LO, cellsize, CORNERS)
        call, one_call = ev.eval_normal_at_cell_corners, one.eval_normal_at_cell_corners
    host = _counted(ev, call, idx, *args)
    dev = _counted(ev, call, torch.as_tensor(idx.astype(np.int32)), *args)
    assert dev[1] == host[1] > 0 and dev[0].shape == host[0].shape
    assert dev[0].device == host[0].device == ev.device
    assert np.array_equal(_bits(to_host(dev[0])), _bits(to_host(host[0])))
    assert np.array_equal(_bits(to_host(dev[0])), _bits(to_host(one_call(idx, *args))))


def test_empty_lists_make_nothing(surface):
    ev, _, _ = surface
    tables = adaptive._tables("cpu")
    cells = torch.zeros((0, 3), dtype=torch.int32)
    signs = torch.zeros((0,), dtype=torch.uint8)
    before = ev.sdf_eval_count
    assert adaptive._ambiguous_edges(ev, tables, cells, signs, LO, 1.0, 7).shape == (0,)
    assert adaptive._canonical_offsets(ev, tables, cells, signs, 4, LO, 0.25).shape == (0, 12)
    keys, pos = adaptive._emit_cells(tables, cells, signs, torch.zeros((0, 12)), 4, 64)
    assert keys.shape == (0, 3) and pos.shape == (0, 3, 3)
    assert ev.eval_sdf_at_lattice(cells, LO, 1.0).shape == (0,)
    assert ev.eval_normal_at_cell_corners(cells, LO, 1.0, CORNERS).shape == (0, 8, 3)
    assert ev.sdf_eval_count == before


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU mode (the device steps' "
                    "torch code is held to the JAX package's helpers above)")
    return torch.device("cuda")


def _host(cells, signs):
    """The host helpers' cells and ±1 corner values of device cells and
    their sign bytes."""
    return cells.cpu().numpy().astype(np.int64), _vals(signs.cpu().numpy())


def _design1_export(device, evaluator):
    """Design1's adaptive export at octree 3 -> 5, grid 2^5, as
    tests/test_torch_adaptive_device.py makes its golden, on ``device``."""
    scene = get_design("design1")
    config = dataclasses.replace(scene.export_config, minimum_octree_level=3,
                                 maximum_octree_level=5, grid_level=5,
                                 gradient_descent_steps=2)
    mp = pytest.MonkeyPatch()
    mp.setattr(native, "available", lambda: False)
    try:
        return export_mesh(scene, config, autodetect_resolution=32, device=device,
                           evaluator=evaluator)
    finally:
        mp.undo()


@pytest.mark.cuda
def test_card_levels_equal_the_numpy_emission(cuda_device, monkeypatch):
    """On the card: each level's device triangles, complexity and ambiguity
    verdicts bit for bit the host helpers' on the same surface cells and
    normals brought to the host (their samples on a second card
    evaluator), and the whole export equal to the export whose level steps
    run on those host helpers."""
    scene = get_design("design1")
    ref_ev = BatchEvaluator(scene, device=cuda_device)
    complex_cells, ambiguous = adaptive._complex_cells, adaptive._ambiguous_edges
    offsets, emit = adaptive._canonical_offsets, adaptive._emit_cells
    checked = {"complexity": 0, "ambiguity": 0, "emit": 0}

    def check_complexity(tables, normals, threshold):
        got = complex_cells(tables, normals, threshold)
        assert got.device.type == "cuda"
        want = _np_edge_angles(normals.cpu().numpy()) > threshold
        np.testing.assert_array_equal(got.cpu().numpy(), want)
        checked["complexity"] += 1
        return got

    def check_ambiguity(evaluator, tables, cells, signs, lo, cellsize, n):
        got = ambiguous(evaluator, tables, cells, signs, lo, cellsize, n)
        assert got.device.type == "cuda"
        want = _np_ambiguous_edges(ref_ev, *_host(cells, signs), lo, cellsize, n)
        np.testing.assert_array_equal(got.cpu().numpy(), want)
        checked["ambiguity"] += 1
        return got

    def check_offsets(evaluator, tables, cells, signs, scale, lo, fine_cell):
        offs = offsets(evaluator, tables, cells, signs, scale, lo, fine_cell)
        hcells, vals = _host(cells, signs)
        want = _np_canonical_offsets(ref_ev, hcells, vals, scale, lo, fine_cell)
        assert np.array_equal(_bits(offs.cpu().numpy()), _bits(want))
        return offs

    def check_emit(tables, cells, signs, offs, scale, fine_res):
        keys, pos = emit(tables, cells, signs, offs, scale, fine_res)
        assert keys.device.type == pos.device.type == "cuda"
        hcells, vals = _host(cells, signs)
        want_keys, want_pos = _np_emit_cells(hcells, vals, offs.cpu().numpy(), scale, fine_res)
        np.testing.assert_array_equal(keys.cpu().numpy(), want_keys)
        assert np.array_equal(_bits(pos.cpu().numpy()), _bits(want_pos))
        checked["emit"] += 1
        return keys, pos

    monkeypatch.setattr(adaptive, "_complex_cells", check_complexity)
    monkeypatch.setattr(adaptive, "_ambiguous_edges", check_ambiguity)
    monkeypatch.setattr(adaptive, "_canonical_offsets", check_offsets)
    monkeypatch.setattr(adaptive, "_emit_cells", check_emit)
    ev = BatchEvaluator(scene, device=cuda_device)
    assert ev.sdf_field == "cuda-exact"
    mesh, report = _design1_export(cuda_device, ev)
    assert checked == {"complexity": 2, "ambiguity": 2, "emit": 3}

    def host_complexity(tables, normals, threshold):
        out = _np_edge_angles(normals.cpu().numpy()) > threshold
        return torch.as_tensor(out, device=normals.device)

    def host_ambiguity(evaluator, tables, cells, signs, lo, cellsize, n):
        out = _np_ambiguous_edges(evaluator, *_host(cells, signs), lo, cellsize, n)
        return torch.as_tensor(out, device=cells.device)

    def host_offsets(evaluator, tables, cells, signs, scale, lo, fine_cell):
        hcells, vals = _host(cells, signs)
        out = _np_canonical_offsets(evaluator, hcells, vals, scale, lo, fine_cell)
        return torch.as_tensor(out, device=cells.device)

    def host_emit(tables, cells, signs, offs, scale, fine_res):
        hcells, vals = _host(cells, signs)
        keys, pos = _np_emit_cells(hcells, vals, offs.cpu().numpy(), scale, fine_res)
        return torch.as_tensor(keys, device=cells.device), torch.as_tensor(pos, device=cells.device)

    monkeypatch.setattr(adaptive, "_complex_cells", host_complexity)
    monkeypatch.setattr(adaptive, "_ambiguous_edges", host_ambiguity)
    monkeypatch.setattr(adaptive, "_canonical_offsets", host_offsets)
    monkeypatch.setattr(adaptive, "_emit_cells", host_emit)
    host_mesh, host_report = _design1_export(cuda_device, BatchEvaluator(scene, device=cuda_device))
    np.testing.assert_array_equal(mesh.faces, host_mesh.faces)
    assert np.array_equal(_bits(mesh.vertices), _bits(host_mesh.vertices))
    assert report.stats["level_triangles"] == host_report.stats["level_triangles"]
    assert report.sdf_evals == host_report.sdf_evals
    assert mesh.num_faces > 1000
