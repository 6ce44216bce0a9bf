"""The evaluator's lattice and cell-corner entry points, its gizmo option,
its normal modes and its route by scene capability, against the JAX
package's ``BatchEvaluator`` and Pallas point kernel on the CPU.  The
lattice entry points leave their values on the device; they come down with
``to_host`` to be compared.

The lattice is offset off Design1's faces (``LO``): at a lattice point on a
face the SDF is exactly 0 in the JAX package and -3e-8 in the port (XLA
rounds the frame transform's dot product differently), and marching cubes
then reads the sign of that zero.  Off the faces, signs agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import designs
from designcsg_tpu.evaluator import BatchEvaluator as JBatchEvaluator
from designcsg_tpu.ops.interpreter import as_device_arrays
from designcsg_tpu.ops.marching_cubes import CORNERS as JCORNERS
from designcsg_tpu.ops.pallas import make_pallas_point_eval
from designcsg_tpu_torch.config import RenderConfig
from designcsg_tpu_torch.designs import get_design
from designcsg_tpu_torch.evaluator import BatchEvaluator, default_use_kernels
from designcsg_tpu_torch.observability import to_host
from designcsg_tpu_torch.ops.cuda.brushes_kernel import supports_scene
from designcsg_tpu_torch.ops.cuda.sdf_kernel import make_point_eval
from designcsg_tpu_torch.ops.marching_cubes import CORNERS
from designcsg_tpu_torch.ops.raymarch import make_renderer, make_scene_renderer
from torch_scenes import custom_brush_scene


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the suite runs one process per
    worker, and a default-sized thread pool in each oversubscribes the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


LO = np.array([-10.0371, -9.9713, -10.0119])
CELL = 20.0 / 32


def _close(got, ref):
    """The point evaluator's rule: ``|d| <= 1e-5 + 1e-6 |ref|``."""
    return bool(np.all(np.abs(got - ref) <= 1e-5 + 1e-6 * np.abs(ref)))


@pytest.fixture(scope="module")
def evaluators():
    return JBatchEvaluator(designs.get_design("design1")), BatchEvaluator(get_design("design1"), device="cpu")


def _cells(n=3000, seed=0, hi=32):
    return np.random.default_rng(seed).integers(0, hi, (n, 3)).astype(np.int64)


def test_sdf_at_lattice_and_corners_match_jax(evaluators):
    jev, tev = evaluators
    cells = _cells()
    assert _close(to_host(tev.eval_sdf_at_lattice(cells, LO, CELL)),
                  jev.eval_sdf_at_lattice(cells, LO, CELL))
    got = to_host(tev.eval_sdf_at_cell_corners(cells, LO, CELL, CORNERS))
    assert got.shape == (3000, 8)
    assert _close(got, jev.eval_sdf_at_cell_corners(cells, LO, CELL, JCORNERS))
    # Non-integer offsets: the midpoints of a cell's faces.
    half = np.array([[0.5, 0.5, 0.0], [0.0, 0.5, 0.5]])
    assert _close(to_host(tev.eval_sdf_at_cell_corners(cells, LO, CELL, half)),
                  jev.eval_sdf_at_cell_corners(cells, LO, CELL, half))


def test_lattice_points_round_as_the_grid_kernel(evaluators):
    """``lo + cell * idx``: a float32 product, then a float32 sum, as
    JAX's ``_lattice_fn`` rounds them: the port's values at the lattice equal
    its own point evaluation of those float32 points bit for bit."""
    _, tev = evaluators
    cells = _cells(500, seed=3)
    lo32, cell32 = LO.astype(np.float32), np.float32(CELL)
    pts = lo32[None, :] + cell32 * cells.astype(np.float32)
    np.testing.assert_array_equal(to_host(tev.eval_sdf_at_lattice(cells, LO, CELL)),
                                  tev.eval_sdf_at_points(pts))


def test_normals_at_lattice_and_corners_match_jax(evaluators):
    """FD normals (6 evaluations 5e-3 apart, normalized) near the surface,
    within 1e-4: the rule of tests/test_torch_interpreter.py's FD normals,
    an ulp of the SDF over the FD step."""
    jev, tev = evaluators
    cells = _cells(4000, seed=1)
    vals = jev.eval_sdf_at_lattice(cells, LO, CELL)
    near = cells[np.abs(vals) < 0.5][:400]
    np.testing.assert_allclose(to_host(tev.eval_normal_at_lattice(near, LO, CELL)),
                               jev.eval_normal_at_lattice(near, LO, CELL), atol=1e-4)
    got = to_host(tev.eval_normal_at_cell_corners(near, LO, CELL, CORNERS))
    assert got.shape == (near.shape[0], 8, 3)
    np.testing.assert_allclose(got, jev.eval_normal_at_cell_corners(near, LO, CELL, JCORNERS), atol=1e-4)


def test_corner_signs_near_match_jax(evaluators):
    jev, tev = evaluators
    cells = _cells(6000, seed=2)
    bound = np.sqrt(3.0) * CELL * 1.1
    signs, near = map(to_host, tev.eval_corner_signs_near(cells, LO, CELL, CORNERS, bound))
    jsigns, jnear = jev.eval_corner_signs_near(cells, LO, CELL, JCORNERS, bound)
    assert signs.dtype == np.uint8 and near.dtype == bool
    np.testing.assert_array_equal(signs, jsigns)
    np.testing.assert_array_equal(near, jnear)
    assert ((signs != 0) & (signs != 255)).any() and near.any() and not near.all()
    # The bound is compared in float32 (ROADMAP F3).
    vals = to_host(tev.eval_sdf_at_cell_corners(cells, LO, CELL, CORNERS))
    np.testing.assert_array_equal(near, np.abs(vals).min(1) <= np.float32(bound))
    with pytest.raises(ValueError, match="K <= 8"):
        tev.eval_corner_signs_near(cells, LO, CELL, np.zeros((9, 3)), bound)


def test_sdf_eval_count_counts_as_jax(evaluators):
    """Every entry point adds what the JAX package's adds: a point per SDF
    evaluation, 6 per FD normal, K per cell of a corner call."""
    jev, tev = evaluators
    cells = _cells(100, seed=4)
    jev.sdf_eval_count = tev.sdf_eval_count = 0
    for ev, corners in ((jev, JCORNERS), (tev, CORNERS)):
        ev.eval_sdf_at_lattice(cells, LO, CELL)
        ev.eval_normal_at_lattice(cells, LO, CELL)
        ev.eval_sdf_at_cell_corners(cells, LO, CELL, corners)
        ev.eval_normal_at_cell_corners(cells[:10], LO, CELL, corners)
        ev.eval_corner_signs_near(cells, LO, CELL, corners, 0.5)
        ev.refine_on_device(np.zeros((7, 3), np.float32), steps=2)
    assert tev.sdf_eval_count == jev.sdf_eval_count == 100 + 600 + 800 + 480 + 800 + 98


def test_chunked_entry_points_equal_unchunked(evaluators):
    """Chunks split cells, never a cell's corners."""
    _, tev = evaluators
    small = BatchEvaluator(get_design("design1"), device="cpu", chunk_size=100)
    cells = _cells(333, seed=5)
    np.testing.assert_array_equal(to_host(small.eval_sdf_at_cell_corners(cells, LO, CELL, CORNERS)),
                                  to_host(tev.eval_sdf_at_cell_corners(cells, LO, CELL, CORNERS)))
    for a, b in zip(small.eval_corner_signs_near(cells, LO, CELL, CORNERS, 0.4),
                    tev.eval_corner_signs_near(cells, LO, CELL, CORNERS, 0.4)):
        np.testing.assert_array_equal(to_host(a), to_host(b))


@pytest.mark.parametrize("name", ["design1", "design2"])
def test_gizmo_point_eval_matches_jax_pallas(name):
    """K1's gizmo option: the port's plain version against JAX's
    ``make_pallas_point_eval(gizmo=True)`` in interpret mode
    (tests/test_pallas.py:69-73), on points along the gizmo's axes and
    around the part, and the gizmo evaluator against JAX's."""
    jscene, tscene = designs.get_design(name), get_design(name)
    rng = np.random.default_rng(7)
    pts = rng.uniform(-3.0, 6.0, (1000, 3)).astype(np.float32)
    for k in range(3):
        pts[k * 100 : (k + 1) * 100] = 0.0
        pts[k * 100 : (k + 1) * 100, k] = np.linspace(0.5, 5.5, 100)
    ref = np.asarray(make_pallas_point_eval(jscene, gizmo=True, interpret=True, sub=8)(
        jnp.asarray(pts), as_device_arrays(jscene.arrays)))
    ours = make_point_eval(tscene, gizmo=True)(torch.from_numpy(pts), tscene.arrays.to_torch("cpu"))
    assert _close(ours.numpy(), ref)
    tev = BatchEvaluator(tscene, device="cpu", gizmo=True)
    assert _close(tev.eval_sdf_at_points(pts), JBatchEvaluator(jscene, gizmo=True).eval_sdf_at_points(pts))
    assert (ref[:300] < BatchEvaluator(tscene, device="cpu").eval_sdf_at_points(pts[:300])).any()


def test_normal_modes():
    """Both normal modes evaluate; the analytic one counts one tape
    evaluation a normal, FD six (tests/test_torch_interpreter_rest.py holds
    the analytic normals against JAX's)."""
    scene = get_design("design1")
    pts = np.array([[3.0, 0.0, 0.0]], np.float32)
    fd = BatchEvaluator(scene, device="cpu", normal_mode="fd")
    analytic = BatchEvaluator(scene, device="cpu", normal_mode="analytic")
    assert fd.eval_normal_at_points(pts).shape == analytic.eval_normal_at_points(pts).shape == (1, 3)
    assert (fd.sdf_eval_count, analytic.sdf_eval_count) == (6, 1)


def test_scene_without_cuda_bodies_takes_the_tape(monkeypatch):
    """P3: a scene with a ``define_brush(fn)``-only brush is routed to the
    plain tape before anything is built -- the evaluator's field is
    "tape-exact" and the renderer's engine "tape" even on the card -- and
    gives the plain path's values and frame.  Design1 takes the kernels.
    The rule is tested, not a launch: nothing is built or moved to a card,
    and the renderer's device check is told that there is one."""
    scene = custom_brush_scene()
    assert not supports_scene(scene)
    assert supports_scene(get_design("design1"))
    assert supports_scene(get_design("design1"), cull=True, gizmo=True)
    cuda = torch.device("cuda")
    assert not default_use_kernels(scene, cuda)
    assert default_use_kernels(get_design("design1"), cuda)
    assert not default_use_kernels(get_design("logo"), cuda)  # its kernels' field is baked
    assert not default_use_kernels(get_design("design1"), torch.device("cpu"))
    assert BatchEvaluator(scene, device="cpu").sdf_field == "tape-exact"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    config = RenderConfig(width=32, height=24, max_steps=48)
    assert make_scene_renderer(scene, config, torch.device("cuda")).engine == "tape"
    assert make_scene_renderer(get_design("design1"), config, torch.device("cuda")).engine == "cuda"
    monkeypatch.undo()
    pts = np.random.default_rng(8).uniform(-1.5, 1.5, (500, 3)).astype(np.float32)
    ev = BatchEvaluator(scene, device="cpu")
    from designcsg_tpu_torch.ops.interpreter import make_primary_sdf

    np.testing.assert_array_equal(
        ev.eval_sdf_at_points(pts),
        make_primary_sdf(scene)(torch.from_numpy(pts), scene.arrays.to_torch("cpu")).numpy())
    from designcsg_tpu_torch.camera import Camera

    cam = Camera.initial().as_arrays()
    render = make_scene_renderer(scene, config, torch.device("cpu"))
    assert render.engine == "tape"
    frame = render(scene.arrays.to_torch("cpu"), *cam)
    np.testing.assert_array_equal(frame.numpy(),
                                  make_renderer(scene, config)(scene.arrays.to_torch("cpu"), *cam).numpy())
    assert (frame.numpy() != frame.numpy()[0, 0]).any()


def test_gizmo_grid_eval_matches_jax_pallas():
    """K3's gizmo option, plain and culled (the gizmo in its own cull slot),
    against JAX's ``make_grid_eval(gizmo=True)`` in interpret mode, on a
    lattice through the gizmo's axes."""
    from designcsg_tpu.ops.pallas import make_grid_eval as jmake_grid_eval
    from designcsg_tpu_torch.ops.cuda.sdf_kernel import make_grid_eval

    jscene, tscene = designs.get_design("design1"), get_design("design1")
    lo, cell, z0, nz, ny, nx = np.array([-0.3, -0.4, -0.2], np.float32), np.float32(0.06), 1.0, 4, 24, 100
    ref = np.asarray(jmake_grid_eval(jscene, gizmo=True, interpret=True)(
        as_device_arrays(jscene.arrays), lo, cell, np.float32(z0), nz, ny, nx))
    arrays = tscene.arrays.to_torch("cpu")
    ours = make_grid_eval(tscene, gizmo=True)(arrays, lo, cell, z0, nz, ny, nx).numpy()
    assert _close(ours, ref)
    np.testing.assert_array_equal(
        make_grid_eval(tscene, gizmo=True, cull=True)(arrays, lo, cell, z0, nz, ny, nx).numpy(), ours)
    assert (ours < make_grid_eval(tscene)(arrays, lo, cell, z0, nz, ny, nx).numpy()).any()
