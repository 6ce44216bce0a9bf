"""The adaptive export's level lists on the evaluator's device: the entry
point ``BatchEvaluator.eval_surface_cells`` against ``eval_corner_signs_near``
bit for bit, the sweep's per-level counts (``stats["level_cells"]`` and the
``extract.corners`` spans' values), its resume files, and two exports held
bit for bit to goldens.

The goldens (``tests/goldens/<design>_adaptive_<min><max><grid>.npz``) hold
the mesh, per-level triangles and SDF evaluations of :func:`_export` at
commit 784d8fa, whose sweep kept every level's cells on the host.  The
card's case runs with the ``cuda`` marker:
``python -m pytest tests/test_torch_adaptive_device.py -m cuda --noconftest -o addopts="" -p no:cacheprovider -q``.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from designcsg_tpu_torch import native
from designcsg_tpu_torch import observability as obs
from designcsg_tpu_torch.compiler import ExportConfig
from designcsg_tpu_torch.designs import get_design
from designcsg_tpu_torch.evaluator import BatchEvaluator
from designcsg_tpu_torch.export.pipeline import export_mesh
from designcsg_tpu_torch.ops.marching_cubes import CORNERS

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
# Off Design1's faces, and on them: with a box of round numbers lattice
# corners fall on the faces, where the SDF is 0 or a rounding from it.
LO_OFF = np.array([-10.0371, -9.9713, -10.0119])
LO_ROUND = np.array([-10.0, -10.0, -10.0])
CELL = 20.0 / 32
# The lattice-edge cases span +-2 (+-2.0371 off the faces), across which
# Design1 reaches: its boundary cells straddle the surface.
EDGE_SCALE = 0.2


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


def _random_cells(n=5000, seed=0, hi=32):
    return np.random.default_rng(seed).integers(0, hi, (n, 3)).astype(np.int64)


def _edge_cells(res=32):
    """Every cell on the lattice's boundary, where the corners reach index
    ``res``, in x-fastest order."""
    r = np.arange(res)
    gz, gy, gx = np.meshgrid(r, r, r, indexing="ij")
    cells = np.stack([gx, gy, gz], -1).reshape(-1, 3)
    return cells[((cells == 0) | (cells == res - 1)).any(1)].astype(np.int64)


def _case(kind, lo, res=32, n=5000):
    """(cells, lo, cell size) of a random or a lattice-edge case."""
    if kind == "random":
        return _random_cells(n, hi=res), lo, CELL * 32 / res
    return _edge_cells(res), lo * EDGE_SCALE, CELL * EDGE_SCALE * 32 / res


def _check_against_host(ev, cells, lo, cell, offsets):
    """``eval_surface_cells`` on the device list against
    ``eval_corner_signs_near`` on the host list: the same rows, cells, sign
    bytes, near flags and evaluation count, all left on the device."""
    bound = np.sqrt(3.0) * cell * 1.1
    before = ev.sdf_eval_count
    signs, near = ev.eval_corner_signs_near(cells, lo, cell, offsets, bound)
    host_count = ev.sdf_eval_count - before
    full = (1 << len(offsets)) - 1
    want = np.nonzero((signs != 0) & (signs != full))[0]
    dev_cells = torch.as_tensor(cells.astype(np.int32), device=ev.device)
    before = ev.sdf_eval_count
    rows, scells, ssigns, dnear = ev.eval_surface_cells(dev_cells, lo, cell, offsets, bound)
    assert ev.sdf_eval_count - before == host_count == len(offsets) * len(cells)
    assert rows.dtype == torch.int64 and scells.dtype == torch.int32
    assert ssigns.dtype == torch.uint8 and dnear.dtype == torch.bool
    assert {t.device.type for t in (rows, scells, ssigns, dnear)} == {ev.device.type}
    np.testing.assert_array_equal(rows.cpu().numpy(), want)
    np.testing.assert_array_equal(scells.cpu().numpy(), cells[want])
    np.testing.assert_array_equal(ssigns.cpu().numpy(), signs[want])
    np.testing.assert_array_equal(dnear.cpu().numpy(), near)
    return want


@pytest.mark.parametrize("lo", [LO_OFF, LO_ROUND], ids=["off_faces", "round_box"])
@pytest.mark.parametrize("kind", ["random", "lattice_edge"])
def test_surface_cells_equal_host_signs(design1_eval, kind, lo):
    cells, lo, cell = _case(kind, lo)
    rows = _check_against_host(design1_eval, cells, lo, cell, CORNERS)
    assert 0 < rows.size < cells.shape[0]


def test_surface_cells_chunked_and_fewer_offsets(design1_eval):
    """Chunks split cells, never a cell's corners; with K < 8 offsets the
    surface is every mix of the K bits."""
    small = BatchEvaluator(get_design("design1"), device="cpu", chunk_size=100)
    cells = _random_cells(777, seed=3)
    np.testing.assert_array_equal(_check_against_host(small, cells, LO_OFF, CELL, CORNERS),
                                  _check_against_host(design1_eval, cells, LO_OFF, CELL, CORNERS))
    assert _check_against_host(design1_eval, cells, LO_OFF, CELL, CORNERS[:4]).size
    empty = torch.zeros((0, 3), dtype=torch.int32)
    rows, scells, signs, near = design1_eval.eval_surface_cells(empty, LO_OFF, CELL, CORNERS, 1.0)
    assert rows.shape == (0,) and scells.shape == (0, 3) and signs.shape == (0,)
    assert near.shape == (0,)


def _config(name, levels, steps=2):
    lo, hi, grid = levels
    scene = get_design(name)
    return scene, dataclasses.replace(scene.export_config, minimum_octree_level=lo,
                                      maximum_octree_level=hi, grid_level=grid,
                                      gradient_descent_steps=steps)


def _export(name, levels, **kw):
    """The design's adaptive export at ``levels`` (min, max, grid) with its
    own autodetect at 32, 2 refine steps and numpy welds on the CPU."""
    scene, config = _config(name, levels)
    mp = pytest.MonkeyPatch()
    mp.setattr(native, "available", lambda: False)
    try:
        return export_mesh(scene, config, autodetect_resolution=32, device="cpu", **kw)
    finally:
        mp.undo()


@pytest.mark.parametrize("name, levels", [("design1", (3, 5, 5)), ("design2", (3, 5, 6))])
def test_export_matches_golden_bit_for_bit(name, levels):
    mesh, report = _export(name, levels)
    golden = np.load(os.path.join(GOLDENS, f"{name}_adaptive_{''.join(map(str, levels))}.npz"))
    assert mesh.faces.dtype == golden["faces"].dtype
    assert mesh.vertices.dtype == golden["vertices"].dtype
    np.testing.assert_array_equal(mesh.faces, golden["faces"])
    np.testing.assert_array_equal(mesh.vertices, golden["vertices"])
    assert sorted(report.stats["level_triangles"].items()) == [
        tuple(t) for t in golden["level_triangles"].tolist()]
    assert report.sdf_evals == int(golden["sdf_evals"])


class _Spy:
    """Wraps an evaluator's ``eval_surface_cells``: keeps each level's list
    (on the host) and its near flags."""

    def __init__(self, ev):
        self.lists, self.near, self._call = [], [], ev.eval_surface_cells
        ev.eval_surface_cells = self

    def __call__(self, cells, *args):
        out = self._call(cells, *args)
        self.lists.append(cells.cpu().numpy().astype(np.int64))
        self.near.append(out[3].cpu().numpy().copy())
        return out


def _children_of(parents):
    return (parents[:, None, :] * 2 + CORNERS[None]).reshape(-1, 3)


def _assert_next_level(prev, near, nxt):
    """``nxt`` is the children of some near cells of ``prev``, in order."""
    parents = nxt[::8] // 2
    np.testing.assert_array_equal(nxt, _children_of(parents))
    where = {tuple(c): i for i, c in enumerate(prev)}
    pos = np.array([where[tuple(c)] for c in parents], np.int64)
    assert np.all(np.diff(pos) > 0) and near[pos].all()


def test_level_cells_are_the_surface_counts(tmp_path):
    """``stats["level_cells"]`` holds each level's cells and the surface
    cells among them, recomputed here from host signs of the lists the
    sweep held; the ``extract.corners`` spans carry the same counts."""
    scene, config = _config("design1", (3, 5, 5), steps=0)
    ev = BatchEvaluator(scene, device="cpu")
    spy = _Spy(ev)
    obs.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        _, report = export_mesh(scene, config, autodetect_resolution=32, evaluator=ev,
                                stl_path=str(tmp_path / "a.stl"))
    counts = report.stats["level_cells"]
    assert sorted(counts) == [3, 4, 5]
    host = BatchEvaluator(scene, device="cpu")
    half = report.bounding_box_half_diameter
    lo = np.asarray(report.bounding_box_center, np.float64) - half
    for L, cells in zip(sorted(counts), spy.lists):
        if L == 3:
            g = np.arange(1 << L)
            gz, gy, gx = np.meshgrid(g, g, g, indexing="ij")
            np.testing.assert_array_equal(cells, np.stack([gx, gy, gz], -1).reshape(-1, 3))
        cellsize = 2.0 * half / (1 << L)
        signs, _ = host.eval_corner_signs_near(cells, lo, cellsize, CORNERS,
                                               np.sqrt(3.0) * cellsize * 1.1)
        assert counts[L] == (cells.shape[0], int(((signs != 0) & (signs != 255)).sum()))
    for prev, near, nxt in zip(spy.lists, spy.near, spy.lists[1:]):
        _assert_next_level(prev, near, nxt)
    values = [s[4] for s in obs.spans() if s[0] == "extract.corners"]
    assert values == [counts[L][1] for L in sorted(counts)]
    assert counts[5][1] < counts[5][0]


class _CrashAfter:
    """Progress callback that raises once extraction passes a fraction."""

    def __init__(self, frac):
        self.frac = frac

    def __call__(self, stage, frac):
        if stage == "EXTRACTING_SURFACE" and frac >= self.frac:
            raise RuntimeError("simulated crash")


def test_resume_after_the_first_level(tmp_path):
    """RESUME_CFG's levels 2 -> 4 (tests/test_torch_adaptive.py), cut once
    the first level is saved: its shard's ``next_cells`` is the host list of
    the next level in today's dtype and order, and the resumed export gives
    the uninterrupted mesh with the later levels' evaluations only."""
    scene = get_design("design1")
    config = ExportConfig(bounding_box_half_diameter=10.0, minimum_octree_level=2,
                          maximum_octree_level=4, grid_level=5, gradient_descent_steps=2)
    kw = dict(autodetect=False, strategy="adaptive", device="cpu")
    ev = BatchEvaluator(scene, device="cpu")
    spy = _Spy(ev)
    ref_mesh, ref_report = export_mesh(scene, config, evaluator=ev, **kw)
    resume = str(tmp_path / "adaptive")
    with pytest.raises(RuntimeError, match="simulated crash"):
        export_mesh(scene, config, resume_dir=resume, progress=_CrashAfter(0.3), **kw)
    (shard,) = glob.glob(os.path.join(resume, "slab_*.npz"))
    assert shard.endswith("_000002.npz")
    with np.load(shard) as data:
        next_cells = data["next_cells"]
    assert next_cells.dtype == np.int64 and next_cells.ndim == 2
    np.testing.assert_array_equal(next_cells, spy.lists[1])
    _assert_next_level(spy.lists[0], spy.near[0], next_cells)

    resumed_ev = BatchEvaluator(scene, device="cpu")
    resumed_spy = _Spy(resumed_ev)
    mesh, report = export_mesh(scene, config, evaluator=resumed_ev, resume_dir=resume, **kw)
    np.testing.assert_array_equal(mesh.faces, ref_mesh.faces)
    np.testing.assert_array_equal(mesh.vertices, ref_mesh.vertices)
    assert len(resumed_spy.lists) == 2
    for got, want in zip(resumed_spy.lists, spy.lists[1:]):
        np.testing.assert_array_equal(got, want)
    assert sorted(report.stats["level_cells"]) == [3, 4]
    assert report.stats["level_cells"][4] == ref_report.stats["level_cells"][4]
    assert report.sdf_evals == resumed_ev.sdf_eval_count < ev.sdf_eval_count


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU mode (its plain version is "
                    "held to the host path above)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "lattice_edge"])
def test_surface_cells_equal_host_signs_on_card(cuda_device, kind):
    """K1 on the card: the device list's surface cells and near flags bit
    for bit those of ``eval_corner_signs_near``, in chunks of 2^20 points
    and of 1,000."""
    for chunk in (1 << 20, 1000):
        ev = BatchEvaluator(get_design("design1"), device=cuda_device, chunk_size=chunk)
        assert ev.sdf_field == "cuda-exact"
        for lo in (LO_OFF, LO_ROUND):
            assert _check_against_host(ev, *_case(kind, lo, res=128, n=300_000), CORNERS).size
